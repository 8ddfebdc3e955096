"""The benchmark's graph generator: arcs drawn from a seed.

A frozen copy of chip_smoke.py's synth_power_law_arcs (itself the arcs of
bench.py's synth_power_law_graph): Zipf-weighted endpoints, p(rank r) ~
r^-0.7 by inverse transform (r = V * u^(1/0.3)), self-loops dropped, the
remaining arcs kept with their multiplicity. The arcs are unweighted.
"""

from __future__ import annotations

import numpy as np


def power_law_arcs(num_vertices: int, num_edges: int, seed: int):
    """(src, dst) int64 arrays of about num_edges arcs over num_vertices."""
    rng = np.random.default_rng(seed)
    draw = lambda: np.minimum(
        (num_vertices * rng.random(num_edges) ** (1 / 0.3)).astype(np.int64),
        num_vertices - 1)
    src = draw()
    dst = draw()
    keep = src != dst
    return src[keep], dst[keep]
