"""Edge-list I/O with the reference's exact parsing semantics, plus output writers.

Parsing parity (reference algorithm/UniformRandomWalk.scala:17-43):
  - tokens split on whitespace; src=col0, dst=col1 (ints)
  - weight = last column parsed as float IF (weighted AND >2 columns), else 1.0;
    unparseable weight falls back to 1.0 (Try(...).getOrElse(1.0f))
  - undirected: both (src->dst) and (dst->src) arcs with the same weight
  - directed: src->dst only, but dst is still registered as a vertex (possibly
    degree-0) so every mentioned vertex seeds a walker
  - multi-edges are preserved, never deduped

Partitioned variant (reference algorithm/VCutRandomWalk.scala:19-41):
  - partition id = col2 IF (partitioned AND >2 columns), else random in
    [0, rddPartitions); unparseable pid falls back to random
  - weight = last column IF (weighted AND >3 columns), else 1.0

Output layout parity (reference README.md:141-166, Main.scala:36-44,
RandomWalk.scala:234-241): `<out>/path` tab-separated vertex-id walks,
`<out>/vec` "id\tv0\tv1..." embeddings, `<out>/bin` model artifacts; single file
(part-00000) when singleOutput else rddPartitions files.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.config import PATH_SUFFIX, VECTOR_SUFFIX
from .csr import CSRGraph, from_adjacency


def _parse_weight(tok: str) -> float:
    try:
        return float(tok)
    except ValueError:
        return 1.0


def load_edge_list(path: str, weighted: bool = True, directed: bool = False,
                   use_native: bool | None = None) -> CSRGraph:
    """Uniform (hash-partitioned) load path — reference UniformRandomWalk.loadGraph.

    use_native=None tries the C++ builder (bit-identical output, ~10-100x faster on
    large inputs) and falls back to pure Python; True forces it, False skips it."""
    if use_native is not False:
        try:
            from .. import native
            g, _ = native.build_graph(path, weighted=weighted, directed=directed)
            return g
        except FileNotFoundError:
            raise
        except Exception:
            if use_native:
                raise
    adj: dict[int, list[tuple[int, float]]] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            src, dst = int(parts[0]), int(parts[1])
            w = _parse_weight(parts[-1]) if (weighted and len(parts) > 2) else 1.0
            adj.setdefault(src, []).append((dst, w))
            if directed:
                adj.setdefault(dst, [])
            else:
                adj.setdefault(dst, []).append((src, w))
    return from_adjacency(adj)


def load_edge_list_partitioned(
    path: str,
    weighted: bool = True,
    directed: bool = False,
    partitioned: bool = False,
    num_partitions: int = 1,
    seed: int = 0,
    use_native: bool | None = None,
) -> tuple[CSRGraph, np.ndarray]:
    """Vertex-cut load path — reference VCutRandomWalk.loadGraph.

    Returns (graph, home_partition i32[V]): home = partition id of the vertex's first
    edge record in file order (the deterministic analog of the reference's reduceByKey
    keeping one record's pId as the vertex home, VCutRandomWalk.scala:49,92-97).
    Unpartitioned records draw a random pid (VCutRandomWalk.scala:23-26; the native
    and Python paths use different RNGs for that fallback, so only explicit partition
    columns are bit-identical across the two loaders).
    """
    if use_native is not False:
        try:
            from .. import native
            return native.build_graph(path, weighted=weighted, directed=directed,
                                      partitioned=partitioned,
                                      num_partitions=num_partitions, seed=seed)
        except FileNotFoundError:
            raise
        except Exception:
            if use_native:
                raise
    rng = np.random.default_rng(seed)
    adj: dict[int, list[tuple[int, float]]] = {}
    home: dict[int, int] = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            src, dst = int(parts[0]), int(parts[1])
            if partitioned and len(parts) > 2:
                try:
                    pid = int(parts[2])
                except ValueError:
                    pid = int(rng.integers(num_partitions))
            else:
                pid = int(rng.integers(num_partitions))
            w = _parse_weight(parts[-1]) if (weighted and len(parts) > 3) else 1.0
            adj.setdefault(src, []).append((dst, w))
            home.setdefault(src, pid)
            if directed:
                adj.setdefault(dst, [])
            else:
                adj.setdefault(dst, []).append((src, w))
            home.setdefault(dst, pid)
    g = from_adjacency(adj)
    home_arr = np.fromiter((home[int(o)] for o in g.ids), dtype=np.int32, count=g.num_vertices)
    return g, home_arr


def _part_files(out_dir: str, n: int) -> list[str]:
    return [os.path.join(out_dir, f"part-{i:05d}") for i in range(n)]


def _id_strs(ids: np.ndarray) -> list:
    """Original-id strings formatted once per vertex (reused across chunks)."""
    return [str(x) for x in ids.tolist()]


def _walk_lines(walks: np.ndarray, id_strs: list) -> list:
    """TSV line rendering for a corpus block, byte-identical to per-element
    str(int(...)) formatting but ~2.6x faster (measured): rows join CACHED
    per-vertex id strings over plain Python lists (np.char's "vectorized"
    string ops are slower than this loop; per-token int formatting was the
    real cost at 10M x 82 scale)."""
    return ["\t".join([id_strs[v] for v in row if v >= 0])
            for row in walks.tolist()]


def save_walks(walks: np.ndarray, graph: CSRGraph, output: str, partitions: int = 1) -> str:
    """Write the walk corpus as tab-separated original vertex ids, one walk per line,
    -1 padding stripped (reference RandomWalk.save:234-241)."""
    out_dir = os.path.join(output, PATH_SUFFIX)
    os.makedirs(out_dir, exist_ok=True)
    files = _part_files(out_dir, max(1, partitions))
    chunks = np.array_split(np.arange(len(walks)), len(files))
    id_strs = _id_strs(graph.ids)
    for fname, idx in zip(files, chunks):
        with open(fname, "w") as f:
            for lo in range(0, len(idx), 1_000_000):  # bound string memory
                block = idx[lo:lo + 1_000_000]
                f.write("\n".join(_walk_lines(walks[block], id_strs)))
                f.write("\n")
    return out_dir


def save_walk_blocks(blocks, graph: CSRGraph, output: str) -> str:
    """Per-process part files from multi-host local corpus blocks — the
    executor-writes-its-own-partition shape (reference RandomWalk.scala:234-241
    repartition/saveAsTextFile: each executor writes its rows; no process ever
    holds the global corpus).

    Each (global_row_start, rows[n, T]) block becomes part-{start//n:05d}
    (one file per device, disjoint across processes); padding rows (start slot
    -1, all-(-1)) are dropped. Reading the part files in name order yields
    exactly the single-process save_walks row order, so the concatenation of
    all hosts' files is byte-identical to a single-process single-file save."""
    out_dir = os.path.join(output, PATH_SUFFIX)
    os.makedirs(out_dir, exist_ok=True)
    id_strs = _id_strs(graph.ids)
    # part naming assumes the global tiling is uniform (every device holds the
    # same row count) — enforce it so a non-uniform caller fails loudly
    # instead of silently colliding/mis-ordering part names
    sizes = {len(rows) for _, rows in blocks}
    assert len(sizes) <= 1, f"blocks must be uniform, got sizes {sizes}"
    for start, rows in blocks:
        n = max(len(rows), 1)
        assert start % n == 0, (start, n)
        real = rows[rows[:, 0] >= 0]
        with open(os.path.join(out_dir, f"part-{start // n:05d}"), "w") as f:
            if len(real):
                f.write("\n".join(_walk_lines(real, id_strs)))
                f.write("\n")
    return out_dir


def save_walks_stream(rounds, total_rows: int, graph: CSRGraph, output: str,
                      partitions: int = 1) -> str:
    """Streaming variant of save_walks: `rounds` yields [W, L+2] blocks in global
    row order; rows are spread over part files with the same boundaries
    np.array_split would produce, without ever materializing the corpus."""
    out_dir = os.path.join(output, PATH_SUFFIX)
    os.makedirs(out_dir, exist_ok=True)
    nfiles = max(1, partitions)
    bounds = [len(c) for c in np.array_split(np.arange(total_rows), nfiles)]
    files = _part_files(out_dir, nfiles)
    fi = 0
    left = bounds[0]
    id_strs = _id_strs(graph.ids)
    f = open(files[fi], "w")
    try:
        for block in rounds:
            lines = _walk_lines(np.asarray(block), id_strs)
            i = 0
            while i < len(lines):
                while left == 0 and fi + 1 < nfiles:
                    f.close()
                    fi += 1
                    left = bounds[fi]
                    f = open(files[fi], "w")
                take = (len(lines) - i if fi + 1 >= nfiles
                        else min(left, len(lines) - i))
                f.write("\n".join(lines[i:i + take]))
                f.write("\n")
                left -= take
                i += take
    finally:
        f.close()
    return out_dir


def load_walks(path: str) -> list[list[int]]:
    """Read a walk corpus (original ids) from a file or a /path-style directory."""
    files = [path]
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.startswith("part-")
        )
    corpus: list[list[int]] = []
    for fn in files:
        with open(fn) as f:
            for line in f:
                toks = line.split()
                if toks:
                    corpus.append([int(t) for t in toks])
    return corpus


_POW10 = 10 ** np.arange(19, dtype=np.int64)


def _parse_uint_lines(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized parse of whitespace-separated non-negative ints with line
    structure. data: uint8 buffer. Returns (values i64[NT], line token counts
    i64[NL]) — empty lines dropped, a final unterminated line included.

    The production walks-file reader: the
    per-token Python loop costs hours at the reference's default corpus
    (10*|V| walks x <=82 tokens, Main.scala:119-121 reads it cluster-wide);
    this is ~10 fused NumPy passes over the byte buffer. Digit runs are
    tokens (any non-digit byte separates), so ids <= 19 digits parse exactly.
    """
    n = len(data)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    digit = (data >= 48) & (data <= 57)
    prev = np.empty_like(digit)
    prev[0] = False
    prev[1:] = digit[:-1]
    nxt = np.empty_like(digit)
    nxt[-1] = False
    nxt[:-1] = digit[1:]
    starts = digit & ~prev
    ends = digit & ~nxt
    idx = np.arange(n, dtype=np.int64)
    start_pos = idx[starts]
    lengths = idx[ends] - start_pos + 1
    if lengths.size and int(lengths.max()) > 19:
        raise ValueError("token exceeds 19 digits (int64 overflow)")
    # contribution of each digit char: d * 10^(digits to its right)
    dmask = np.flatnonzero(digit)
    tok_of = np.repeat(np.arange(len(start_pos), dtype=np.int64), lengths)
    local = dmask - start_pos[tok_of]
    contrib = (data[dmask].astype(np.int64) - 48) * \
        _POW10[lengths[tok_of] - 1 - local]
    bounds = np.zeros(len(start_pos), dtype=np.int64)
    np.cumsum(lengths[:-1], out=bounds[1:])
    values = np.add.reduceat(contrib, bounds) if len(bounds) else \
        np.zeros(0, np.int64)
    if len(values) and values.min() < 0:
        # a 19-digit token above 2^63-1 wraps negative in the int64 sum —
        # error like the >19-digit case (same contract as the native parser)
        raise ValueError("token exceeds int64 range")
    # tokens per line: token starts before each newline (+ the final tail)
    nl = idx[data == 10]
    cum_at_nl = np.searchsorted(start_pos, nl)
    cum = np.concatenate([[0], cum_at_nl,
                          [len(start_pos)]]).astype(np.int64)
    per_line = np.diff(cum)
    return values, per_line[per_line > 0]


def load_walks_ragged(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read a walk corpus as ragged arrays: (values i64[NT], offsets i64[NW+1])
    — walk w is values[offsets[w]:offsets[w+1]]. Vectorized (seconds for
    millions of lines vs hours for the per-token Python path); token values
    and walk order are identical to load_walks."""
    files = [path]
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("part-"))
    try:
        from .. import native
        _parse = native.parse_walks if native.available() else _parse_uint_lines
    except Exception:
        _parse = _parse_uint_lines
    vals: list[np.ndarray] = []
    lens: list[np.ndarray] = []
    for fn in files:
        with open(fn, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
        v, l = _parse(data)
        vals.append(v)
        lens.append(l)
    values = np.concatenate(vals) if vals else np.zeros(0, np.int64)
    lengths = np.concatenate(lens) if lens else np.zeros(0, np.int64)
    offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return values, offsets


def save_vectors(ids: np.ndarray, vectors: np.ndarray, output: str, partitions: int = 1) -> str:
    """Write embeddings as "<orig-id>\\t<v0>\\t<v1>..." (reference Main.scala:40-43)."""
    out_dir = os.path.join(output, VECTOR_SUFFIX)
    os.makedirs(out_dir, exist_ok=True)
    files = _part_files(out_dir, max(1, partitions))
    chunks = np.array_split(np.arange(len(ids)), len(files))
    for fname, idx in zip(files, chunks):
        with open(fname, "w") as f:
            for lo in range(0, len(idx), 200_000):  # bound string memory
                block = idx[lo:lo + 200_000]
                # tolist() once: repr over native Python floats is ~3x cheaper
                # than over numpy scalars (byte-identical text)
                rows = vectors[block].tolist()
                ids_l = ids[block].tolist()
                f.write("\n".join(
                    f"{i}\t" + "\t".join(repr(x) for x in row)
                    for i, row in zip(ids_l, rows)))
                f.write("\n")
    return out_dir
