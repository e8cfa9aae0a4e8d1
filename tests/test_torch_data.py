"""The port's datasets (``glass_tpu_torch/data``) and RCM ordering
(``glass_tpu_torch/native.py``) against glass_tpu's, on the CPU: every array
equal.

Miniatures: a networkx ``dataset_/density/tmp.npy`` (as tests/test_cli.py
writes one) and SubGNN-format TSVs, binary and multilabel, one of them with
a val split smaller than test (the reference's swap), with edge lists that
hold blank lines, lines of one value, lines with extra columns, tabs and
CRLF line ends. The RCM fallback: both packages on their scipy branch
(each native library unloaded); tests/test_torch_native.py holds the two
native branches equal.
"""

import sys

import numpy as np
import pytest

from glass_tpu import native as jnative
from glass_tpu.data import basegraph as jbg
from glass_tpu.data import loaders as jld
from glass_tpu_torch import native as tnative
from glass_tpu_torch.data import basegraph as tbg
from glass_tpu_torch.data import loaders as tld

FIELDS = ("x", "edge_index", "edge_weight", "pos", "y", "mask")


def assert_same_data(a, b):
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert va.dtype == vb.dtype, f
        np.testing.assert_array_equal(va, vb, err_msg=f)
    assert (a.n_node, a.binary, a.output_channels, a.max_deg) == \
        (b.n_node, b.binary, b.output_channels, b.max_deg)


@pytest.fixture
def density_root(tmp_path):
    import networkx as nx

    rng = np.random.default_rng(0)
    n = 120
    g = nx.Graph()
    g.add_nodes_from(range(n))
    src = rng.integers(0, n, size=500)
    dst = rng.integers(0, n, size=500)
    g.add_edges_from(zip(src.tolist(), dst.tolist()))
    subg = [sorted(rng.choice(n, size=int(rng.integers(3, 8)),
                              replace=False).tolist()) for _ in range(200)]
    labels = ["ABC"[i % 3] for i in range(200)]
    d = tmp_path / "dataset_" / "density"
    d.mkdir(parents=True)
    np.save(d / "tmp.npy", {"G": g, "subG": subg, "subGLabel": labels})
    return str(tmp_path)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_loader_matches(density_root, seed):
    a = jld.load_dataset("density", np.random.default_rng(seed), density_root)
    b = tld.load_dataset("density", np.random.default_rng(seed), density_root)
    assert_same_data(a, b)
    assert set(np.unique(b.mask)) == {0, 1, 2}


def test_synthetic_loader_names_networkx_when_missing(density_root,
                                                      monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "networkx"]:
        monkeypatch.setitem(sys.modules, name, None)
    monkeypatch.setitem(sys.modules, "networkx", None)
    with pytest.raises(ModuleNotFoundError, match="needs the networkx"):
        tld.load_dataset("density", np.random.default_rng(0), density_root)


EDGE_TEXTS = {
    "plain": "0 1\n1 2\n2 0\n3 4\n",
    "blank_lines_tabs_crlf": "0\t1\r\n\r\n1  2\n\n   \n2 3\r\n3 0",
    "one_value_lines": "0 1\n7\n1 2\n2 3\n",
    "extra_columns": "0 1 0.5\n1 2 1.5 x\n2 3\n",
    "cr_line_ends": "0\r1 2\r2 3\r",
}


def write_subgnn(root, name, multilabel, edge_text, swap=False):
    rng = np.random.default_rng(1)
    d = root / "dataset" / name
    d.mkdir(parents=True)
    tags = ["train"] * 3 + (["test", "test", "val"] if swap
                            else ["val", "test"])
    lines = []
    for i in range(24):
        nodes = rng.choice(10, size=int(rng.integers(2, 6)), replace=False)
        lab = "AB"[i % 2] if not multilabel else ["A-C", "B", "C-A-B"][i % 3]
        lines.append(f"{'-'.join(map(str, nodes))}\t{lab}\t"
                     f"{tags[i % len(tags)]}\n")
    lines.insert(3, "\tA\ttrain\n")  # no nodes: skipped
    (d / "subgraphs.pth").write_text("".join(lines))
    (d / "edge_list.txt").write_bytes(edge_text.encode())


@pytest.mark.parametrize("edges", sorted(EDGE_TEXTS))
@pytest.mark.parametrize("multilabel,swap", [(False, False), (True, False),
                                             (False, True)],
                         ids=["binary", "multilabel", "val_test_swap"])
def test_subgnn_loader_matches(tmp_path, monkeypatch, edges, multilabel,
                               swap):
    name = "hpo_metab"
    write_subgnn(tmp_path, name, multilabel, EDGE_TEXTS[edges], swap)
    monkeypatch.setenv("GLASS_CACHE_DIR", str(tmp_path / "cache"))
    a = jld.load_real(name, str(tmp_path))
    b = tld.load_real(name, str(tmp_path))
    assert_same_data(a, b)
    if swap:  # the larger split became val
        assert (b.mask == 1).sum() > (b.mask == 2).sum()
    cached = list((tmp_path / "cache").glob(f"{name}_*.npz"))
    assert len(cached) == 1
    assert_same_data(a, tld.load_real(name, str(tmp_path)))  # from the cache


@pytest.mark.parametrize("text", sorted(EDGE_TEXTS))
def test_edge_list_parse_equals_line_by_line(tmp_path, text):
    p = tmp_path / "edge_list.txt"
    p.write_bytes(EDGE_TEXTS[text].encode())
    ref = []
    with open(p) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                ref.append((int(parts[0]), int(parts[1])))
    out = tld.read_edge_list(p)
    assert out.dtype == np.int64
    np.testing.assert_array_equal(out, np.array(ref, dtype=np.int64).T)
    fast = tld._edge_pairs_fast(p.read_bytes())
    assert (fast is not None) == (text in ("plain", "blank_lines_tabs_crlf"))


def test_hpo_neuro_is_never_cached(tmp_path, monkeypatch):
    write_subgnn(tmp_path, "hpo_neuro", True, EDGE_TEXTS["plain"])
    monkeypatch.setenv("GLASS_CACHE_DIR", str(tmp_path / "cache"))
    assert_same_data(jld.load_real("hpo_neuro", str(tmp_path)),
                     tld.load_real("hpo_neuro", str(tmp_path)))
    assert not (tmp_path / "cache").exists()


def test_missing_dataset_and_unknown_name(tmp_path):
    with pytest.raises(FileNotFoundError, match="GLASS_DATA_ROOT"):
        tld.load_dataset("em_user", None, str(tmp_path))
    with pytest.raises(NotImplementedError, match="unknown dataset"):
        tld.load_dataset("nope")


def edge_cases(rng):
    e = rng.integers(0, 30, (2, 80))
    sym = np.concatenate([e, e[::-1]], axis=1)
    loops = np.concatenate([sym, np.stack([np.arange(5)] * 2)], axis=1)
    dup = np.concatenate([sym, sym[:, :20]], axis=1)
    asym = np.concatenate([sym, [[3], [29]]], axis=1)  # (3, 29) alone
    return {"symmetric": sym, "self_loops": loops, "duplicates": dup,
            "asymmetric": asym, "directed": e,
            "empty": np.zeros((2, 0), np.int64),
            "offset_ids": sym + 1000}


@pytest.mark.parametrize("case", sorted(edge_cases(np.random.default_rng(0))))
def test_is_undirected_and_undirect_match(case):
    ei = edge_cases(np.random.default_rng(0))[case]
    assert tbg.is_undirected(ei) == jbg.is_undirected(ei)
    if ei.shape[1]:
        np.testing.assert_array_equal(tbg.undirect(ei), jbg.undirect(ei))
        assert tbg.is_undirected(tbg.undirect(ei))


def test_basegraph_matches(rng):
    n = 50
    e = rng.integers(0, n, (2, 200))
    w = np.ones(200, np.float32)
    pos = np.full((12, 6), -1, np.int64)
    for i in range(12):
        k = int(rng.integers(1, 7))
        pos[i, :k] = rng.choice(n, k, replace=False)
    y = (rng.random((12, 3)) > 0.5).astype(np.float32)
    mask = rng.integers(0, 3, 12)
    args = dict(x=np.zeros((n, 1), np.int64), edge_index=e, edge_weight=w,
                pos=pos, y=y, mask=mask)
    a = jbg.BaseGraphData(**{k: v.copy() for k, v in args.items()})
    b = tbg.BaseGraphData(**{k: v.copy() for k, v in args.items()})
    assert_same_data(a, b)  # post-init undirect of the directed edges
    for setter in ("set_one_feature", "set_degree_feature",
                   "set_node_id_feature"):
        getattr(a, setter)()
        getattr(b, setter)()
        assert_same_data(a, b)
    a.set_degree_feature()
    b.set_degree_feature()
    perm = rng.permutation(n)
    a.relabel_nodes(perm)
    b.relabel_nodes(perm)
    assert_same_data(a, b)
    for split in ("train", "valid", "test"):
        for u, v in zip(a.get_split(split), b.get_split(split)):
            np.testing.assert_array_equal(u, v)
    np.testing.assert_array_equal(tbg.relabel_pos(pos, perm, n),
                                  jbg.relabel_pos(pos, perm, n))


@pytest.mark.parametrize("graph", ["banded", "random", "disconnected"])
def test_rcm_matches_jax_scipy_branch(monkeypatch, rng, graph):
    monkeypatch.setattr(jnative, "_load", lambda: None)
    monkeypatch.setattr(tnative, "_load", lambda: None)
    n = 300
    if graph == "banded":
        r = rng.integers(0, n, 1500)
        c = np.clip(r + rng.integers(-9, 10, 1500), 0, n - 1)
        e = np.stack([r, c])
    elif graph == "random":
        e = rng.integers(0, n, (2, 1200))
    else:
        e = rng.integers(0, n // 3, (2, 300)) * 3  # every third node only
    e = np.concatenate([e, e[::-1]], axis=1)
    perm = tnative.rcm_ordering(e, n)
    np.testing.assert_array_equal(perm, jnative.rcm_ordering(e, n))
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(np.sort(perm), np.arange(n))
