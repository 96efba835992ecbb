"""The counting functions against hand counts on a small support."""
import numpy as np
import pytest

from bench import heads
from bench.metrics import _counting as cnt
from bench.reference.nai import EdgeGraph

# 0-1, 1-2, 2-3, 3-4, 1-5, both ways, and a self loop at every node
_U = np.array([0, 1, 2, 3, 1])
_V = np.array([1, 2, 3, 4, 5])
SRC = np.concatenate([_U, _V, np.arange(6)])
DST = np.concatenate([_V, _U, np.arange(6)])


def test_step_needs_hand_count():
    g = EdgeGraph(6, SRC, DST)
    assert g.indeg.tolist() == [2, 4, 3, 3, 2, 2]
    assert g.deg.tolist() == [1, 3, 2, 2, 1, 1]
    s1, s2 = cnt.step_needs(g, np.array([0, 3]), np.array([1, 2]), f=4,
                            t_min=1, t_max=2)
    # step 1: both nodes active; rows within 1 hop: {0,1,2,3,4}, their
    # in-edges 2+4+3+3+2, their sources every node
    assert (s1.edges, s1.rows_out, s1.rows_in, s1.active) == (14, 5, 6, 2)
    assert s1.flops == 2 * 14 * 4 + 3 * 2 * 4
    assert s1.bytes == 14 * 8 + 5 * 4 + 6 * 16 + 5 * 16 + (2 * 4 + 4 * 4 + 2)
    # step 2: node 3 alone, its own row from its 3 in-neighbours
    assert (s2.edges, s2.rows_out, s2.rows_in, s2.active) == (3, 1, 3, 1)
    assert s2.flops == 2 * 3 * 4
    assert s2.bytes == 3 * 8 + 4 + 3 * 16 + 16


@pytest.mark.parametrize("model,expected", [("sgc", 2 * (14 + 14)),
                                            ("gamlp", 2 * (42 + 56))])
def test_head_flops_hand_count(model, expected):
    gcfg = dict(base_model=model, feat_dim=4, num_classes=3, hidden=2,
                mlp_layers=2, att_dim=2, k=2)
    assert heads.mlp_dims(gcfg, 4) == [4, 2, 3]
    assert cnt.head_flops(heads.load(model), gcfg,
                          np.array([1, 2])) == expected


def test_roofline_takes_the_larger_bound():
    assert cnt.roofline_s(67e12, 1.0, 67e12, 3.35e12) == 1.0
    assert cnt.roofline_s(1.0, 3.35e12, 67e12, 3.35e12) == 1.0
