"""Neural-network functions of the port (counterpart of
``paddle_tpu.nn``); so far the loss the Llama trainer needs."""
