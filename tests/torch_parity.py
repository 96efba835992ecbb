"""Shared helpers of the tests that hold the PyTorch port (`repro_torch`)
against the JAX package (`repro`): the small test geometry and the
threshold-margin rule for exit orders."""
import dataclasses

import numpy as np

# a node's exit order may legitimately differ between two implementations
# when one of its decision-step squared distances lies this close (relative)
# to the squared threshold: f32 sums over <= 512 features taken in another
# order differ by far less (~1e-6 relative)
D2_MARGIN = 1e-4
# ... and no more than this share of the nodes may fall in that margin, or
# the configuration is too close to the threshold to test anything
MAX_NEAR_SHARE = 0.05


def small_graph(load_dataset, features=64):
    """pubmed-like at scale 0.02 (seed 4), sliced to `features` columns
    (64: one FB feature block, the geometry of
    tests/test_engine_compiled.py)."""
    g = load_dataset("pubmed-like", scale=0.02, seed=4)
    return dataclasses.replace(
        g, features=np.ascontiguousarray(g.features[:, :features]))


def near_threshold(decision_distances, cfg, nai, g, nodes, batch_size):
    """Bool per request: does any decision-step d² of the node lie within
    D2_MARGIN of t_s²? Batches are formed as the engine forms them from a
    queue (consecutive chunks, deduped)."""
    nodes = np.asarray(nodes)
    near = np.zeros(len(nodes), bool)
    ts2 = nai.t_s ** 2
    for lo in range(0, len(nodes), batch_size):
        chunk = nodes[lo:lo + batch_size]
        uniq, inv = np.unique(chunk, return_inverse=True)
        d = decision_distances(cfg, nai, g, uniq)
        close = (np.abs(d ** 2 - ts2) <= D2_MARGIN * ts2).any(axis=1)
        near[lo:lo + len(chunk)] = close[inv]
    return near


def assert_orders_match(pa, oa, pb, ob, near):
    """Predictions and exit orders equal on every node outside the
    margin; the margin holds at most MAX_NEAR_SHARE of the nodes."""
    assert near.mean() <= MAX_NEAR_SHARE, (
        f"{near.sum()} of {len(near)} nodes within the threshold margin")
    keep = ~near
    np.testing.assert_array_equal(oa[keep], ob[keep])
    np.testing.assert_array_equal(pa[keep], pb[keep])
