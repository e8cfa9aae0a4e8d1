"""Dataset loading for the 8 GLASS benchmark datasets (counterpart of
``glass_tpu/data/loaders.py``).

Synthetic (density, coreness, cut_ratio, component): un-pickle the bundled
``dataset_/{name}/tmp.npy`` (a dict with a networkx graph, subgraph node
lists and letter labels), pad the subgraphs with -1, and regenerate a random
50/25/25 split at load time exactly as the reference does; the stored mask
is ignored (reference: datasets.py:105-126). Unpickling needs networkx,
which is imported by the pickle alone, never by this module.

Real-world (ppi_bp, hpo_metab, hpo_neuro, em_user): parse the SubGNN-format
``subgraphs.pth`` TSV (nodes joined by '-', labels, train/val/test tag) and
``edge_list.txt`` (reference: datasets.py:127-227). Multilabel targets
become k-hot matrices. The parsed arrays are cached as ``.npz`` under
``$GLASS_CACHE_DIR``, else ``~/.cache/glass_tpu_torch``.

Data roots are searched in order: ``$GLASS_DATA_ROOT``, then ``./``, as
the JAX package searches its first two (its third is a fixed path to the
reference checkout; point ``$GLASS_DATA_ROOT`` or ``data_root`` there).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from glass_tpu_torch.data.basegraph import BaseGraphData

SYNTHETIC_DATASETS = ("density", "coreness", "cut_ratio", "component")
REAL_DATASETS = ("ppi_bp", "hpo_metab", "hpo_neuro", "em_user")

_DEFAULT_ROOTS = (
    os.environ.get("GLASS_DATA_ROOT", ""),
    ".",
)


def _find(relpath: str, data_root: Optional[str]) -> Path:
    roots = (data_root,) if data_root else _DEFAULT_ROOTS
    for root in roots:
        if not root:
            continue
        p = Path(root) / relpath
        if p.exists():
            return p
    raise FileNotFoundError(
        f"{relpath} not found under any of {[r for r in roots if r]}; "
        "set GLASS_DATA_ROOT or download the dataset (see reference README)"
    )


def _pad_pos(subgraphs: list) -> np.ndarray:
    width = max(len(s) for s in subgraphs)
    pos = np.full((len(subgraphs), width), -1, dtype=np.int64)
    for i, s in enumerate(subgraphs):
        pos[i, : len(s)] = s
    return pos


def random_synthetic_mask(n_sub: int, rng: np.random.Generator) -> np.ndarray:
    """50/25/25 split regenerated per load (reference: datasets.py:118-123):
    train = cnt - cnt//2, val = cnt//4, test = cnt//2 - cnt//4, permuted."""
    mask = np.concatenate([
        np.zeros(n_sub - n_sub // 2, dtype=np.int64),
        np.ones(n_sub // 4, dtype=np.int64),
        2 * np.ones(n_sub // 2 - n_sub // 4, dtype=np.int64),
    ])
    return mask[rng.permutation(n_sub)]


def load_synthetic(
    name: str,
    rng: Optional[np.random.Generator] = None,
    data_root: Optional[str] = None,
) -> BaseGraphData:
    rng = rng or np.random.default_rng(0)
    path = _find(f"dataset_/{name}/tmp.npy", data_root)
    try:
        obj = np.load(path, allow_pickle=True).item()
    except ModuleNotFoundError as e:
        raise ModuleNotFoundError(
            f"{path} pickles a networkx graph: loading the synthetic "
            f"dataset {name!r} needs the networkx package ({e})") from e
    g = obj["G"]
    edge = np.array([[i[0] for i in g.edges], [i[1] for i in g.edges]])
    pos = _pad_pos(obj["subG"])
    y = np.array([ord(c) - ord("A") for c in obj["subGLabel"]], dtype=np.int64)
    mask = random_synthetic_mask(pos.shape[0], rng)
    n_node = g.number_of_nodes()
    return BaseGraphData(
        x=np.zeros((n_node, 1), dtype=np.int64),
        edge_index=edge,
        edge_weight=np.ones(edge.shape[1], dtype=np.float32),
        pos=pos,
        y=y,
        mask=mask,
    )


def _read_subgraphs_tsv(path: Path):
    """SubGNN subgraphs.pth TSV parser (reference: datasets.py:131-178)."""
    label_idx = 0
    labels: dict = {}
    multilabel = False
    splits = {"train": ([], []), "val": ([], []), "test": ([], [])}
    with open(path) as fin:
        for line in fin:
            parts = line.split("\t")
            nodes = [int(n) for n in parts[0].split("-") if n != ""]
            if not nodes:
                continue
            labs = parts[1].split("-")
            if len(labs) > 1:
                multilabel = True
            for lab in labs:
                if lab not in labels:
                    labels[lab] = label_idx
                    label_idx += 1
            tag = parts[2].strip()
            if tag in splits:
                splits[tag][0].append(nodes)
                splits[tag][1].append([labels[lab] for lab in labs])
    tr, va, te = splits["train"], splits["val"], splits["test"]
    # reference quirk: if the val split is smaller than test, swap them
    # (datasets.py:175-176)
    if len(va[0]) < len(te[0]):
        va, te = te, va
    return tr, va, te, multilabel


def _edge_pairs_fast(data: bytes) -> Optional[np.ndarray]:
    """(2, E) int64 edges of an edge list whose bytes are ASCII digits,
    spaces, tabs and line ends only, and whose every line holds no value
    or exactly two; None for any other file. Lines end at '\\n' or '\\r',
    as in text-mode reading."""
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return None
    digit = (buf >= ord("0")) & (buf <= ord("9"))
    end = (buf == ord("\n")) | (buf == ord("\r"))
    if not (digit | end | (buf == ord(" ")) | (buf == ord("\t"))).all():
        return None
    starts = np.flatnonzero(digit & ~np.concatenate([[False], digit[:-1]]))
    del digit
    line = np.searchsorted(np.flatnonzero(end), starts)
    counts = np.bincount(line)
    if starts.size == 0 or ((counts != 0) & (counts != 2)).any():
        return None
    vals = np.fromstring(data, dtype=np.int64, sep=" ")
    if vals.size != starts.size:
        return None
    return vals.reshape(-1, 2).T


def read_edge_list(path: Path) -> np.ndarray:
    """The (2, E) int64 edges of ``edge_list.txt``: the first two values of
    every line that has at least two (reference: datasets.py:215-221). A
    file of plain two-column lines is parsed vectorized; any other goes
    through the JAX loader's line-by-line parse, with identical arrays."""
    fast = _edge_pairs_fast(Path(path).read_bytes())
    if fast is not None:
        return fast
    edges = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                edges.append((int(parts[0]), int(parts[1])))
    return np.array(edges, dtype=np.int64).T


def _real_cache_path(name: str, sub_path: Path, edge_path: Path) -> Optional[Path]:
    """Parsed-dataset cache (npz mirror of the reference's .pt caches,
    datasets.py:180-201). The reference always re-parses hpo_neuro; quirk
    kept. Keyed by the source mtimes, so a stale cache busts itself."""
    if name == "hpo_neuro":
        return None
    cdir = Path(os.environ.get("GLASS_CACHE_DIR",
                               Path.home() / ".cache" / "glass_tpu_torch"))
    key = f"{name}_{int(sub_path.stat().st_mtime)}_{int(edge_path.stat().st_mtime)}"
    return cdir / f"{key}.npz"


def load_real(name: str, data_root: Optional[str] = None) -> BaseGraphData:
    sub_path = _find(f"dataset/{name}/subgraphs.pth", data_root)
    edge_path = _find(f"dataset/{name}/edge_list.txt", data_root)
    cache = _real_cache_path(name, sub_path, edge_path)
    if cache is not None and cache.exists():
        d = np.load(cache)
        return BaseGraphData(
            x=d["x"], edge_index=d["edge_index"], edge_weight=d["edge_weight"],
            pos=d["pos"], y=d["y"], mask=d["mask"],
        )
    tr, va, te, multilabel = _read_subgraphs_tsv(sub_path)

    all_subs = tr[0] + va[0] + te[0]
    all_labs = tr[1] + va[1] + te[1]
    mask = np.concatenate([
        np.zeros(len(tr[0]), dtype=np.int64),
        np.ones(len(va[0]), dtype=np.int64),
        2 * np.ones(len(te[0]), dtype=np.int64),
    ])
    if multilabel:
        k = max(max(l) for l in all_labs) + 1
        y = np.zeros((len(all_labs), k), dtype=np.float32)
        for i, ll in enumerate(all_labs):
            y[i, ll] = 1.0
    else:
        y = np.array([l[0] for l in all_labs], dtype=np.int64)

    pos = _pad_pos(all_subs)
    edge_index = read_edge_list(edge_path)
    n_node = int(max(pos.max(), edge_index.max()) + 1)
    base = BaseGraphData(
        x=np.zeros((n_node, 1), dtype=np.int64),
        edge_index=edge_index,
        edge_weight=np.ones(edge_index.shape[1], dtype=np.float32),
        pos=pos,
        y=y,
        mask=mask,
    )
    if cache is not None:
        from glass_tpu_torch.utils.checkpoint import atomic_savez

        cache.parent.mkdir(parents=True, exist_ok=True)
        atomic_savez(
            cache, x=base.x, edge_index=base.edge_index,
            edge_weight=base.edge_weight, pos=base.pos, y=base.y, mask=base.mask,
        )
    return base


def load_dataset(
    name: str,
    rng: Optional[np.random.Generator] = None,
    data_root: Optional[str] = None,
) -> BaseGraphData:
    if name in SYNTHETIC_DATASETS:
        return load_synthetic(name, rng, data_root)
    if name in REAL_DATASETS:
        return load_real(name, data_root)
    raise NotImplementedError(f"unknown dataset {name!r}")
