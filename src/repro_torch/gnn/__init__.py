from repro_torch.gnn.graph import Graph, propagated_series, stationary_weights
from repro_torch.gnn.backends import (BACKENDS, PropagationBackend,
                                      get_backend, register_backend,
                                      run_propagation)
from repro_torch.gnn.convert import params_from_numpy
from repro_torch.gnn.datasets import PRESETS, load_dataset
from repro_torch.gnn.models import (Classifiers, GNNConfig,
                                    classification_macs, init_classifiers)
from repro_torch.gnn.nai import (NAIConfig, NAIResult, accuracy, infer_all,
                                 make_compiled_infer)
from repro_torch.gnn.packing import (PackedSupport, batch_bucket,
                                     next_bucket, pack_support,
                                     step_active_blocks)
from repro_torch.gnn.sampler import Support, sample_support
from repro_torch.gnn.store import GraphStore, InMemoryStore, as_store

__all__ = [
    "Graph", "propagated_series", "stationary_weights", "BACKENDS",
    "PropagationBackend", "get_backend", "register_backend",
    "run_propagation", "params_from_numpy", "PRESETS", "load_dataset",
    "Classifiers", "GNNConfig", "classification_macs", "init_classifiers",
    "NAIConfig", "NAIResult", "accuracy", "infer_all",
    "make_compiled_infer", "PackedSupport",
    "batch_bucket", "next_bucket", "pack_support", "step_active_blocks",
    "Support", "sample_support", "GraphStore", "InMemoryStore", "as_store",
]
