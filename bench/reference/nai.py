"""Plain reference of Node-Adaptive Inference.

Written from the paper's equations in plain PyTorch, with nothing of the
program under test, from the generated edge list, features and heads'
weights:

* the propagation operator Â = D̃^{r-1} Ã D̃^{-r} (Eq. 1) as a sparse CSR
  matrix of the whole graph, and X^(l) = Â^l X for l <= t_max. A batch
  node's value at order l <= t_max depends only on nodes within l hops,
  all inside its t_max-hop support with their edges, so the whole-graph
  series is the series on any batch's support;
* a batch's support by breadth-first search over in-neighbours, t_max
  hops, and the stationary state of Eq. 7 over that support:
  x_inf[i] = (d_i+1)^r / (2m + S) * sum_{j in S} (d_j+1)^{1-r} x_j;
* the Eq. 8 distance ||X^(l)_i - x_inf[i]|| at each decision order
  t_min <= l < t_max, the exit at the first order under T_s (else
  t_max), and every head f^(l) on the node's own series, by the
  configuration's head architecture (`bench/heads/`).

By default all of it is float64. ``dtype=float32`` with ``tf32=True`` is
the control: the same arithmetic one precision below the float32 with
TF32 off that the configurations state, every matrix product in TF32 as
tensor cores compute it, the operands rounded to TF32's 10-bit mantissa
and the products summed in float32 (for the heads on the card PyTorch's
own switch; for the sparse propagation, and on the CPU, the operands
rounded first). The sparse product shares no summation code with the
program's gather + ``index_add_`` or its block-ELL kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Callable, Dict, Optional

import numpy as np
import torch


class EdgeGraph:
    """The edge list (src -> dst, self loops included) on a device."""

    def __init__(self, n: int, src, dst, device="cpu"):
        dev = torch.device(device)
        self.n, self.device = n, dev
        self.src = torch.as_tensor(np.asarray(src), dtype=torch.int64,
                                   device=dev)
        self.dst = torch.as_tensor(np.asarray(dst), dtype=torch.int64,
                                   device=dev)
        self.loop = self.src == self.dst
        self.indeg = torch.bincount(self.dst, minlength=n)
        self.deg = self.indeg - torch.bincount(self.dst[self.loop],
                                               minlength=n)

    def mask(self, nodes) -> torch.Tensor:
        m = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        m[torch.as_tensor(np.asarray(nodes), dtype=torch.int64,
                          device=self.device)] = True
        return m

    def expand(self, mask: torch.Tensor, hops: int) -> torch.Tensor:
        """`mask` and every node within `hops` in-neighbour steps of it."""
        for _ in range(hops):
            nxt = mask.clone()
            nxt[self.src[mask[self.dst]]] = True
            mask = nxt
        return mask


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10-bit mantissa, nearest even)."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(device: torch.device, tf32: bool):
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def matmul_tf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The product as tensor cores compute it in TF32, on any device."""
    return _tf32(a) @ _tf32(w)


@dataclasses.dataclass
class BatchReference:
    nodes: np.ndarray        # (nb,) the batch, distinct ids
    orders: np.ndarray       # (nb,) exit order of each node
    dist: np.ndarray         # (nb, t_max - t_min) distance at each decision
    logits: np.ndarray       # (t_max, nb, C) head f^(l) on its own series
    support: np.ndarray      # (S,) the support's nodes, sorted
    support_edges: int       # undirected edges of the induced subgraph


class Reference:
    """The whole-graph series and heads, then Algorithm 1 per batch.
    `logits` is a head module's (`bench.heads`): f^(l)'s logits from
    order l's weights, the series and a matrix product."""

    def __init__(self, graph: EdgeGraph, features: np.ndarray,
                 heads: Dict[int, Dict], *, logits: Optional[Callable],
                 r: float, t_min: int, t_max: int, t_s: float,
                 dtype=torch.float64, tf32: bool = False):
        g, dev = graph, graph.device
        self.g, self.logits, self.r = g, logits, r
        self.t_min, self.t_max, self.t_s = t_min, t_max, t_s
        self.dtype, self.tf32 = dtype, tf32
        dt = (g.deg + 1).to(torch.float64)
        self.dt = dt
        coef = dt[g.dst] ** (r - 1.0) * dt[g.src] ** (-r)
        order = torch.argsort(g.dst * g.n + g.src)
        crow = torch.zeros(g.n + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(g.indeg, 0)
        with warnings.catch_warnings():   # "sparse CSR support is in beta"
            warnings.simplefilter("ignore")
            a_hat = torch.sparse_csr_tensor(
                crow, g.src[order], coef[order].to(dtype), size=(g.n, g.n),
                check_invariants=False)
        x = torch.as_tensor(np.asarray(features, np.float32),
                            device=dev).to(dtype)
        if tf32:
            a_hat = torch.sparse_csr_tensor(
                a_hat.crow_indices(), a_hat.col_indices(),
                _tf32(a_hat.values()), size=a_hat.shape,
                check_invariants=False)
        series = [x]
        for _ in range(t_max):
            series.append(a_hat @ (_tf32(series[-1]) if tf32
                                   else series[-1]))
        self.series = torch.stack(series)
        self.heads = {l: {k: torch.as_tensor(np.asarray(v), device=dev).to(
            dtype) for k, v in heads.get(l, {}).items()}
            for l in range(1, t_max + 1)}

    def support_mask(self, nodes) -> torch.Tensor:
        """The batch's support: every node within t_max hops."""
        return self.g.expand(self.g.mask(nodes), self.t_max)

    def batch(self, nodes) -> BatchReference:
        g = self.g
        nodes = np.asarray(nodes, np.int64)
        idx = torch.as_tensor(nodes, device=g.device)
        sup = self.support_mask(nodes)
        n_sup = int(sup.sum())
        m = int((sup[g.src] & sup[g.dst] & ~g.loop).sum()) // 2
        w = (self.dt ** (1.0 - self.r)).to(self.dtype)
        s = (torch.where(sup, w, 0)[:, None] * self.series[0]).sum(dim=0)
        c = (self.dt[idx] ** self.r / (2.0 * m + n_sup)).to(self.dtype)
        x_inf = c[:, None] * s[None, :]
        ser = self.series[:, idx]
        dist = [torch.linalg.vector_norm(ser[l] - x_inf, dim=1)
                for l in range(self.t_min, self.t_max)]
        dist_np = (torch.stack(dist, dim=1).cpu().numpy().astype(np.float64)
                   if dist else np.zeros((len(nodes), 0)))
        orders = np.full(len(nodes), self.t_max, np.int64)
        for j in range(dist_np.shape[1] - 1, -1, -1):
            orders[dist_np[:, j] < self.t_s] = self.t_min + j
        mm = (matmul_tf32 if self.tf32 and g.device.type != "cuda"
              else torch.matmul)
        with torch.inference_mode(), _matmul_precision(g.device, self.tf32):
            logits = np.stack([
                self.logits(self.heads[l], ser, l, mm)
                .cpu().numpy().astype(np.float64)
                for l in range(1, self.t_max + 1)])
        return BatchReference(
            nodes=nodes, orders=orders, dist=dist_np, logits=logits,
            support=torch.nonzero(sup)[:, 0].cpu().numpy(), support_edges=m)


def first_step_distance_quantile(graph: EdgeGraph, features: np.ndarray,
                                 r: float, q: float = 0.5) -> float:
    """The `q` quantile over every node of ||X^(1) - X^inf|| on the whole
    graph (Eq. 8 at the first order, Eq. 7 over every node), float64: the
    configurations' rule for T_s."""
    ref = Reference(graph, features, {}, logits=None, r=r, t_min=1,
                    t_max=1, t_s=0.0)
    g = graph
    m = int((~g.loop).sum()) // 2
    w = ref.dt ** (1.0 - r)
    s = (w[:, None] * ref.series[0]).sum(dim=0)
    c = ref.dt ** r / (2.0 * m + g.n)
    d = torch.linalg.vector_norm(ref.series[1] - c[:, None] * s[None, :],
                                 dim=1)
    return float(np.quantile(d.cpu().numpy(), q))

