"""The labeled-synthetic quality gate of the JAX package
(tests/test_datasets.py::test_quality_pipeline_small) on the port: its own
walks and its conv trainer (shared negatives, kB = 64) on the CPU, the
same graph, walks and trainer settings, held to the same micro-F1 bar; and
the port's walks equal to the JAX package's on that graph."""

import jax
import numpy as np
import torch

from stellar_rw_tpu.graph import datasets as jdatasets
from stellar_rw_tpu.walk import engine as jengine
from stellar_rw_tpu_torch.graph import datasets
from stellar_rw_tpu_torch.models import eval as ev
from stellar_rw_tpu_torch.models import word2vec as w2v
from stellar_rw_tpu_torch.walk import engine

torch.set_num_threads(2)


def test_quality_pipeline_small_on_the_port():
    g, labels = datasets.synth_labeled_graph(1500, 15_000, communities=6,
                                             seed=7)
    walks = engine.random_walks(g, walk_length=20, num_walks=3, p=0.25,
                                q=0.25, seed=1, device="cpu")
    jg, _ = jdatasets.synth_labeled_graph(1500, 15_000, communities=6,
                                          seed=7)
    with jax.enable_x64(False):
        want = jengine.random_walks(jg, walk_length=20, num_walks=3, p=0.25,
                                    q=0.25, seed=1)
    np.testing.assert_array_equal(walks, np.asarray(want))
    cfg = w2v.SGNSConfig(dim=32, window=5, negatives=5, lr=0.1, iters=3,
                         seed=1, shared_negatives=64)
    w_in, _ = w2v.train_skipgram(walks, g.num_vertices, cfg, device="cpu")
    f1 = ev.multilabel_micro_f1(w_in, labels, train_frac=0.5, seed=0)
    assert f1 > 0.55, f1   # chance is ~1/6 primary + overlap noise
