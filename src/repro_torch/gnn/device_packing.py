"""The segment operand set packed on the device, from a support that never
left it.

`pack_support_device(sup, tables, ...)` takes a `DeviceSupport` (the
device sampler's `sample_device`) and the store's `FeatureTables` (the
sampler's `feature_tables`) and returns the `PackedSupport` that
`repro_torch.gnn.packing.pack_support(build_tiles=False,
x_inf_factors=...)` would build from the same support, with device tensors
for arrays: the zero-padded ``x0``, the stationary state's rank-1 factors
``c_inf`` / ``s_inf`` and its dense ``x_inf``, and the bucket-padded edge
list ``src`` / ``dst`` / ``coef`` (the tile operands are empty). It takes
its sizes from `pack_rows` and `edge_bucket`, the host packer's own bucket
rules, so both give the same `shape_key`. The host reads nothing: every
size is one the sampler already read.

Precision. Every array but ``s_inf`` and ``x_inf`` equals the host
path's bit for bit:

* ``x0``, ``src``, ``dst`` and ``coef`` are copies and integer shifts;
* ``c_inf = float32(cr[batch] / (2 sub_edges + S))``: ``cr`` holds numpy's
  ``(deg + 1) ** r`` per node, the host path's expression on the same
  float64, and a float64 division is correctly rounded on both sides (the
  divisor is a device tensor: PyTorch multiplies by the reciprocal of a
  host scalar);
* ``s = sum_i w_i x0_i`` takes the same float64 products (``w`` likewise
  numpy's ``(deg + 1) ** (1 - r)``; a product is correctly rounded). numpy
  adds them row after row. So does the CPU here (the last row of
  ``cumsum``), so ``s`` is bit-equal there; CUDA's reduction adds in a
  tree, within ~1e-16 relative, which moves ``s_inf`` and
  ``x_inf = c_inf ⊗ s_inf`` by at most one float32 ulp.

Every launch goes to the caller's current stream, the one that runs the
batch: `out`, a pooled set of an earlier batch, is rewritten only after
the work queued before it on that stream, which is the batch that read
it.
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Optional

import torch

from repro_torch.gnn.device_sampler import DeviceSupport, FeatureTables
from repro_torch.gnn.packing import PackedSupport, edge_bucket, pack_rows
from repro_torch.kernels.spmm import CB, RB


def _none(part: str) -> ContextManager:
    return contextlib.nullcontext()


def pack_support_device(sup: DeviceSupport, tables: FeatureTables, *,
                        nb_bucket: Optional[int] = None,
                        s_bucket: Optional[int] = None,
                        e_bucket: Optional[int] = None,
                        out: Optional[PackedSupport] = None,
                        part: Callable[[str], ContextManager] = _none
                        ) -> PackedSupport:
    """Pack `sup` into the segment backend's operands on the device of
    `tables`. Buckets are floors, as `pack_support`'s; `out` is a set this
    function made before, refilled in place where every shape matches
    (``reused`` True). `part(name)` wraps the three parts, ``"gather"``
    (geometry, buffers, x0), ``"factors"`` and ``"pack"`` (the edges)."""
    feats, w, cr = tables
    dev = feats.device
    nb, S, E, f = sup.n_batch, len(sup), sup.n_edges, feats.shape[1]
    with part("gather"):
        nb_bucket, n_pad, f_pad = pack_rows(nb, S, f, nb_bucket=nb_bucket,
                                            s_bucket=s_bucket)
        e_pad = edge_bucket(E, e_bucket)
        reuse = (out is not None and out.x0.shape == (n_pad, f_pad)
                 and out.x_inf.shape == (nb_bucket, f_pad)
                 and out.src.shape == (e_pad,))
        if reuse:
            p = out
            p.x0.zero_()
        else:
            f32, i32 = torch.float32, torch.int32
            p = PackedSupport(
                tiles=torch.empty((n_pad // RB, 0, RB, CB), dtype=f32,
                                  device=dev),
                tile_col=torch.empty((n_pad // RB, 0), dtype=i32, device=dev),
                valid=torch.empty((n_pad // RB, 0), dtype=i32, device=dev),
                hop_rb=None, n_batch=nb_bucket, nb_real=nb, n_pad=n_pad,
                s_real=S,
                x0=torch.zeros((n_pad, f_pad), dtype=f32, device=dev),
                x_inf=torch.empty((nb_bucket, f_pad), dtype=f32, device=dev),
                src=torch.empty(e_pad, dtype=i32, device=dev),
                dst=torch.empty(e_pad, dtype=i32, device=dev),
                coef=torch.empty(e_pad, dtype=f32, device=dev),
                c_inf=torch.empty(nb_bucket, dtype=f32, device=dev),
                s_inf=torch.empty(f_pad, dtype=f32, device=dev))
        p.n_batch, p.nb_real, p.n_pad, p.s_real = nb_bucket, nb, n_pad, S
        p.reused = reuse
        # support rows in local order; batch rows first, the rest after
        # the padded batch region (`packing._remap_rows`)
        xs = feats.index_select(0, sup.nodes)
        p.x0[:nb, :f] = xs[:nb]
        p.x0[nb_bucket:nb_bucket + S - nb, :f] = xs[nb:]
    with part("factors"):
        prod = w[sup.nodes][:, None] * xs
        s = prod.cumsum(0)[-1] if dev.type == "cpu" else prod.sum(0)
        denom = torch.full((1,), 2.0 * sup.sub_edges + S,
                           dtype=torch.float64, device=dev)
        c = (cr[sup.nodes[:nb]] / denom).to(torch.float32)
        s = s.to(torch.float32)
        p.c_inf.zero_()
        p.c_inf[:nb] = c
        p.s_inf.zero_()
        p.s_inf[:f] = s
        p.x_inf.zero_()
        p.x_inf[:nb, :f] = c[:, None] * s[None, :]
    with part("pack"):
        # pad edges: zero-coefficient self edges on the last row
        shift = nb_bucket - nb
        p.src.fill_(n_pad - 1)
        p.dst.fill_(n_pad - 1)
        p.coef.zero_()
        p.src[:E] = torch.where(sup.src < nb, sup.src, sup.src + shift)
        p.dst[:E] = torch.where(sup.dst < nb, sup.dst, sup.dst + shift)
        p.coef[:E] = sup.coef
    return p
