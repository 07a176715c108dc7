"""Device wiring of the tensor-parallel ``DecodeEngine``: meshes, the
Megatron split of the stacked weights and the kv-head split of the KV
pools. Counterpart of ``paddle_tpu.inference.sharding``.

- What splits over ``tp``: the paged KV pools ``[L, N, bs, kvh, hd]``
  over their kv-head axis, the int8 page scales ``[L, N, kvh]`` beside
  them, and the attention and MLP weights, Megatron style: the columns
  of ``wq/wk/wv/w_gate/w_up`` (and of the biases), the rows of
  ``wo/w_down``. Embedding, norms and ``lm_head`` replicate.
- What stays on the host, once: the allocator, block tables, lengths
  and windows. Page ids index the pools' global page axis, so one
  allocation decision is valid on every rank.

One controller drives every rank (the reference's shard_map
semantics): the model's serving functions take a list of per-rank
shards, run each rank's column-parallel part and its attention kernel
on that rank's device, and sum the row-parallel partials in rank order.
A mesh may name one device more than once, so that a single card or the
CPU can hold a tp=2 mesh. The reference's second (``seq``) axis, which
splits the pools' pages, is not ported: the engine refuses a mesh whose
``seq`` extent is above 1.
"""

from __future__ import annotations

import torch

__all__ = ["TP_AXIS", "SEQ_AXIS", "Mesh", "make_tp_mesh", "make_mesh",
           "validate_tp_config", "validate_mesh_config",
           "stacked_weight_specs", "pool_specs", "same_pool_placement",
           "shard", "shard_weights"]

TP_AXIS = "tp"
SEQ_AXIS = "seq"

# The Megatron layout over the stacked [L, ...] parameters, as the
# dimension each name splits: column-parallel weights split their output
# features, row-parallel weights the matching contraction axis (their
# products are summed over the ranks). The expert names are listed as in
# the reference; the port's model refuses mixture of experts.
_COL_LAST = ("wq", "wk", "wv", "w_gate", "w_up", "ws_gate", "ws_up")
_COL_BIAS = ("bq", "bk", "bv")
_ROW_AXIS1 = ("wo", "w_down", "ws_down")
_EXPERT_COL = ("we_gate", "we_up")      # [L, E, d, ff]: split ff
_EXPERT_ROW = ("we_down",)              # [L, E, ff, d]: split ff
_SPLIT_DIM = {**dict.fromkeys(_COL_LAST, 2), **dict.fromkeys(_COL_BIAS, 1),
              **dict.fromkeys(_ROW_AXIS1, 1),
              **dict.fromkeys(_EXPERT_COL, 3),
              **dict.fromkeys(_EXPERT_ROW, 2)}


class Mesh:
    """A named grid of devices: ``devices`` in row-major order over
    ``axis_names``, ``shape`` the extent of each axis. A device may
    appear more than once."""

    def __init__(self, devices, axis_names, shape):
        self.devices = tuple(torch.device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(shape[a]) for a in self.axis_names}
        n = 1
        for a in self.axis_names:
            n *= self.shape[a]
        if n != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} needs {n} devices, "
                             f"got {len(self.devices)}")


def _devices(devices):
    """The explicit list as torch devices, else every CUDA device."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_tp_mesh(tp_degree, devices=None, axis=TP_AXIS):
    """A 1-D mesh of ``tp_degree`` devices for the sharded engine.
    ``devices``: an explicit list, which may repeat a device (two ranks
    on one card, or on the CPU); default the first ``tp_degree`` CUDA
    devices."""
    devs = _devices(devices)
    if len(devs) < tp_degree:
        raise ValueError(f"tp_degree={tp_degree} needs {tp_degree} devices, "
                         f"have {len(devs)}")
    return Mesh(devs[:tp_degree], (axis,), {axis: tp_degree})


def make_mesh(tp_degree, seq_degree=1, devices=None, tp_axis=TP_AXIS,
              seq_axis=SEQ_AXIS):
    """A 2-D ``(seq, tp)`` mesh of ``seq_degree x tp_degree`` devices,
    ``seq`` the outer axis. The engine takes it with ``seq_degree=1``
    only (the page-sharded axis is not ported)."""
    tp, sq = int(tp_degree), int(seq_degree)
    if tp < 1 or sq < 1:
        raise ValueError(f"tp_degree={tp_degree}, seq_degree={seq_degree}")
    need = tp * sq
    devs = _devices(devices)
    if len(devs) < need:
        raise ValueError(f"tp_degree={tp} x seq_degree={sq} needs {need} "
                         f"devices, have {len(devs)}")
    return Mesh(devs[:need], (seq_axis, tp_axis), {seq_axis: sq, tp_axis: tp})


def validate_tp_config(cfg, tp):
    """Divisibility the kv-head split requires (the 1-D form of
    :func:`validate_mesh_config`)."""
    validate_mesh_config(cfg, tp)


def validate_mesh_config(cfg, tp, seq=1, n_blocks=None):
    """Divisibility the mesh requires, checked when the engine is built.
    Every violated constraint is reported in one message."""
    if tp < 1:
        raise ValueError(f"tp_degree={tp}")
    if seq < 1:
        raise ValueError(f"seq_degree={seq}")
    problems = []
    kvh = cfg.num_key_value_heads
    if kvh % tp:
        msg = (f"num_key_value_heads={kvh} not divisible by tp={tp} "
               f"(the KV pool shards over kv heads)")
        if tp > kvh:
            msg += (f"; tp={tp} exceeds the {kvh} kv heads outright — "
                    f"shard the page axis instead: a 2-D mesh "
                    f"(make_mesh) with tp_degree<={kvh} and "
                    f"seq_degree>1 lifts the device count past the "
                    f"kv-head cap")
        problems.append(msg)
    if cfg.num_attention_heads % tp:
        problems.append(
            f"num_attention_heads={cfg.num_attention_heads} not "
            f"divisible by tp={tp}")
    if cfg.intermediate_size % tp:
        problems.append(
            f"intermediate_size={cfg.intermediate_size} not divisible "
            f"by tp={tp}")
    if n_blocks is not None and seq > 1 and n_blocks % seq:
        problems.append(
            f"n_blocks={n_blocks} not divisible by seq={seq} (the pool "
            f"page axis shards over seq)")
    if problems:
        raise ValueError("invalid mesh config: " + "; ".join(problems))


def stacked_weight_specs(names):
    """The dimension of each stacked ``[L, ...]`` parameter that splits
    over ``tp``, by name; None for one that replicates (norms)."""
    return {n: _SPLIT_DIM.get(n) for n in names}


def pool_specs(n_pool):
    """The dimension that splits over ``tp`` of each pool the engine
    holds: the kv-head axis of kp/vp ``[L, N, bs, kvh, hd]`` and, for
    int8 pools (``n_pool`` 4), of the page scales ``[L, N, kvh]``."""
    return (3, 3, 2, 2) if n_pool == 4 else (3, 3)


def same_pool_placement(mesh_a, mesh_b) -> bool:
    """True when two engines' pools sit on the same devices, so a page
    copy between them stays on the devices: both unsharded, or both on
    meshes of the same devices in the same order."""
    if mesh_a is None and mesh_b is None:
        return True
    if mesh_a is None or mesh_b is None:
        return False
    return mesh_a.devices == mesh_b.devices


def shard(t, dim, devices):
    """``t`` split along ``dim`` into ``len(devices)`` equal parts, part
    r on ``devices[r]``; ``dim`` None replicates. With one device the
    one part is ``t`` itself (moved there if it lies elsewhere), so an
    unsharded mesh copies nothing."""
    n = len(devices)
    if dim is None or n == 1:
        return [t.to(d) for d in devices]
    size = t.shape[dim] // n
    return [t.narrow(dim, r * size, size).to(d).contiguous()
            for r, d in enumerate(devices)]


def shard_weights(stacked, devices):
    """The stacked parameters split for the ranks on ``devices``: one
    dict of ``[L, ...]`` shards per rank (:func:`stacked_weight_specs`)."""
    specs = stacked_weight_specs(stacked)
    parts = {n: shard(w, specs[n], devices) for n, w in stacked.items()}
    return [{n: p[r] for n, p in parts.items()} for r in range(len(devices))]
