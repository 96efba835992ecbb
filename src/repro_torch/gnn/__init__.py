from repro_torch.gnn.graph import Graph, propagated_series, stationary_weights
from repro_torch.gnn.backends import (BACKENDS, PropagationBackend,
                                      get_backend, register_backend,
                                      run_propagation)
from repro_torch.gnn.convert import params_from_numpy, params_to_numpy
from repro_torch.gnn.datasets import PRESETS, load_dataset
from repro_torch.gnn.distill import (DistillConfig, evaluate_classifier,
                                     train_nai)
from repro_torch.gnn.models import (Classifiers, GNNConfig,
                                    classification_macs, init_classifiers)
from repro_torch.gnn.nai import (NAIConfig, NAIResult, accuracy, infer_all,
                                 make_compiled_infer, order_distribution)
from repro_torch.gnn.packing import (PackedSupport, batch_bucket,
                                     next_bucket, pack_support,
                                     step_active_blocks)
from repro_torch.gnn.propcache import PropCache
from repro_torch.gnn.sampler import Support, sample_support
from repro_torch.gnn.store import (GraphStore, InMemoryStore, MmapStore,
                                   StoreCorruption, StoreError, StoreIOError,
                                   as_store, make_graph, save_graph_store)

__all__ = [
    "Graph", "propagated_series", "stationary_weights", "BACKENDS",
    "PropagationBackend", "get_backend", "register_backend",
    "run_propagation", "params_from_numpy", "params_to_numpy", "PRESETS",
    "load_dataset", "DistillConfig", "evaluate_classifier", "train_nai",
    "Classifiers", "GNNConfig", "classification_macs", "init_classifiers",
    "NAIConfig", "NAIResult", "accuracy", "infer_all",
    "make_compiled_infer", "order_distribution", "PackedSupport",
    "batch_bucket", "next_bucket", "pack_support", "step_active_blocks",
    "PropCache", "Support", "sample_support", "GraphStore", "InMemoryStore",
    "MmapStore", "StoreCorruption", "StoreError", "StoreIOError", "as_store",
    "make_graph", "save_graph_store",
]
