"""The port's table builder against the JAX package's: `absent_key` equal
to `hashtable._absent_key`, and every packed table bit-equal for kv2,
kv4, kv8 and split, with no call of `_absent_key` on the way."""

import numpy as np
import pytest

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops import hashtable
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.ops import index as tindex

from test_torch_probe import dupe_panel

LAYOUTS = ("kv2", "kv4", "kv8", "split")
# kv width per layout as the JAX dispatch packs them
KV_WIDTH = {"kv2": 2, "kv4": 4, "kv8": 8}


def _absent_cases():
    rng = np.random.default_rng(0)
    big = rng.integers(2**31, 2**32, 500, dtype=np.uint64).astype(np.uint32).view(np.int32)
    return {
        "empty": np.zeros(0, np.int32),
        "zero_to_k": np.arange(37, dtype=np.int32),
        "zero_to_k_shuffled_dupes": np.concatenate(
            [rng.permutation(50), rng.integers(0, 50, 40)]).astype(np.int32),
        "gap_at_5": np.array([0, 1, 2, 3, 4, 6, 7, 6, 0], np.int32),
        "no_zero": np.array([1, 2, 3], np.int32),
        "negative_int32": np.concatenate([big, np.array([0, 1, -1, -2], np.int32)]),
        "only_high": big,
        "random_wide": rng.integers(-2**31, 2**31, 5000).astype(np.int32),
        "uint32_input": np.array([0, 1, 2, 0xFFFFFFFF, 4], np.uint32),
    }


@pytest.mark.parametrize("case", sorted(_absent_cases()))
def test_absent_key_matches_jax(case):
    present = _absent_cases()[case]
    assert tindex.absent_key(present) == hashtable._absent_key(present)


def test_absent_key_edges():
    assert tindex.absent_key(np.zeros(0, np.int32)) == 0
    assert tindex.absent_key(np.arange(9, dtype=np.int32)) == 9
    assert tindex.absent_key(np.array([-1, -2], np.int32)) == 0


def _indexer(panel, tmp):
    _, csv = write_panel_files(panel, str(tmp))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv), Settings())
    ix.make_index()
    return ix


@pytest.fixture(scope="module")
def indexers(tmp_path_factory):
    return {
        "make_panel": _indexer(make_panel(), tmp_path_factory.mktemp("plain")),
        "dupes": _indexer(dupe_panel(), tmp_path_factory.mktemp("dupes")),
    }


def _fields(p):
    """Every field that reaches the device or the probe's parameters."""
    if hasattr(p, "kv_tbl"):
        return dict(kind="kv", kv_tbl=p.kv_tbl, dupes=p.dupes, n_buckets=p.n_buckets,
                    shift=p.shift, cbits=p.cbits, pos_bias=p.pos_bias,
                    max_dupe=p.max_dupe, empty_key=p.empty_key)
    return dict(kind="split", table=p.table, keys_tbl=p.keys_tbl, vals_tbl=p.vals_tbl,
                dupes=p.dupes, n_buckets=p.n_buckets, shift=p.shift,
                max_dupe=p.max_dupe, empty_key=p.empty_key)


def _assert_equal(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("panel", ["make_panel", "dupes"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_packed_index_bit_equal(indexers, panel, layout, monkeypatch):
    ix = indexers[panel]
    exp = hashtable.build_packed_index(ix, layout=layout)

    def refuse(_):
        raise AssertionError("the port's builder called hashtable._absent_key")

    monkeypatch.setattr(hashtable, "_absent_key", refuse)
    got = tindex.build_packed_index(ix, layout=layout)
    _assert_equal(got, exp)
    if layout == "split":
        assert not hasattr(got, "kv_tbl")
    else:
        assert got.kv_tbl.shape[1] == KV_WIDTH[layout]
    if panel == "dupes":
        c = got.table[:, :, 1] if layout == "split" else None
        assert got.max_dupe > 1
        assert c is None or ((c == hashtable.DUPE).any() and (c == hashtable.HIGH).any())


@pytest.mark.parametrize("layout", ["kv4", "split"])
def test_table_layout_env_is_honoured(indexers, layout, monkeypatch):
    ix = indexers["make_panel"]
    monkeypatch.setenv("GENEFUSE_TABLE_LAYOUT", layout)
    got = tindex.build_packed_index(ix)
    _assert_equal(got, hashtable.build_packed_index(ix))
    assert _fields(got)["kind"] == ("split" if layout == "split" else "kv")
    if layout == "kv4":
        assert got.kv_tbl.shape[1] == 4
    monkeypatch.delenv("GENEFUSE_TABLE_LAYOUT")
    assert tindex.build_packed_index(ix).kv_tbl.shape[1] == 2


def test_engine_builds_with_the_port_builder(indexers, monkeypatch):
    from genefuserust_tpu_torch.parallel.engine import TorchEngine

    def refuse(*_):
        raise AssertionError("the JAX table builder was called")

    monkeypatch.setattr(hashtable, "build_packed_index", refuse)
    monkeypatch.setattr(hashtable, "_absent_key", refuse)

    class M:
        indexer = indexers["dupes"]

    eng = TorchEngine(Settings(), device="cpu")
    m = M()
    e = eng._table_entry(m)
    assert eng._table_entry(m) is e and e["mapper"] is m
    assert e["packed"].kv_tbl.shape[1] == 2 and eng.table_seconds > 0


@pytest.mark.parametrize("panel", ["make_panel", "dupes"])
@pytest.mark.parametrize("layout", ["kv2", "kv4", "kv8"])
def test_kv_tables_hold_each_key_in_one_slot_of_its_two_rows(indexers, panel, layout):
    # the invariant that makes the probe's h1-first lookup equal to the
    # plain version's p1 | p2: each panel key matches exactly one slot
    # across its h1 and h2 rows, and every empty slot holds the sentinel
    # with payload 0
    from genefuserust_tpu_torch.ops.hashtable import _entries_from_indexer

    p = tindex.build_packed_index(indexers[panel], layout=layout)
    S = p.kv_tbl.shape[1] // 2
    keys = np.unique(_entries_from_indexer(indexers[panel])[0].astype(np.uint32))
    tkeys, pay = p.kv_tbl[:, :S], p.kv_tbl[:, S:]
    sentinel = np.uint32(p.empty_key).view(np.int32)
    ki = keys.view(np.int32)[:, None]
    b1 = hashtable.h1_np(keys, p.shift)
    b2 = hashtable.h2_np(keys, p.shift)
    n1 = (tkeys[b1] == ki).sum(1)
    n2 = np.where(b2 != b1, (tkeys[b2] == ki).sum(1), 0)
    assert ((n1 + n2) == 1).all()
    empty = tkeys == sentinel
    assert (pay[empty] == 0).all()
    assert (pay[~empty] != 0).all()
    assert int((~empty).sum()) == len(keys)
    assert not (keys == np.uint32(p.empty_key)).any()


@pytest.mark.parametrize("panel", ["make_panel", "dupes"])
def test_pow4_rounding_past_max_buckets_is_named(indexers, panel, caplog):
    # the reference gives a kv layout up silently when rounding its bucket
    # count to an even power of two alone passes max_buckets; the port gives
    # it up too, with a warning, and packs bit-equal tables below the cap
    from genefuserust_tpu_torch.ops.hashtable import _entries_from_indexer

    ix = indexers[panel]
    n = len(_entries_from_indexer(ix)[0])
    forced = 0
    for layout, (load, slots) in {"kv2": (0.5, 1), "kv4": (0.6, 2), "kv8": (0.9, 4)}.items():
        nb = 16
        while nb * slots * load < n:
            nb *= 2
        if not (nb.bit_length() - 1) & 1:
            continue  # no rounding for this layout at this key count
        forced += 1
        caplog.clear()
        with caplog.at_level("WARNING", logger="genefuse"):
            got = tindex._pack_kv(ix, load, slots, max_buckets=nb)
        assert got is None and hashtable.pack_index_kv(ix, load, slots, max_buckets=nb) is None
        assert f"{layout} table layout given up" in caplog.text
        caplog.clear()
        with caplog.at_level("WARNING", logger="genefuse"):
            got = tindex._pack_kv(ix, load, slots, max_buckets=2 * nb)
        _assert_equal(got, hashtable.pack_index_kv(ix, load, slots, max_buckets=2 * nb))
        assert "given up" not in caplog.text
    assert forced
