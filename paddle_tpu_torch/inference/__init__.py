"""Paged serving of the port: block allocator, radix prefix cache,
request scheduler and the continuous-batching ``DecodeEngine``."""
