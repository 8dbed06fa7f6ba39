"""The port's table builder against the JAX package's: `absent_key` equal
to `hashtable._absent_key`, and every packed table bit-equal for kv2,
kv4, kv8, kvs, kv16 and split, with no call of `_absent_key` on the way:
on the panels, on key sets that force the single-probe packers' overflow
flags, eviction rescue and constrained walk, and through the fall-through
of a single-probe layout that cannot be packed."""

import numpy as np
import pytest

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops import hashtable
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.ops import index as tindex

from test_kvs import _fake_indexer
from test_torch_probe import dupe_panel

LAYOUTS = ("kv2", "kv4", "kv8", "kvs", "kv16", "split")
# kv width per layout as the JAX dispatch packs them
KV_WIDTH = {"kv2": 2, "kv4": 4, "kv8": 8, "kvs": 8, "kv16": 16}


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


def _refuse_absent_key(_):
    raise AssertionError("the port's builder called hashtable._absent_key")


@pytest.mark.parametrize("panel", ["make_panel", "dupes"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_packed_index_bit_equal(indexers, panel, layout, monkeypatch):
    ix = indexers[panel]
    exp = hashtable.build_packed_index(ix, layout=layout)

    monkeypatch.setattr(hashtable, "_absent_key", _refuse_absent_key)
    got = tindex.build_packed_index(ix, layout=layout)
    _assert_equal(got, exp)
    assert tindex.layout_name(got) == tindex.layout_name(exp) == layout
    if layout == "split":
        assert not hasattr(got, "kv_tbl")
    else:
        assert got.kv_tbl.shape[1] == KV_WIDTH[layout]
    if panel == "dupes":
        c = got.table[:, :, 1] if layout == "split" else None
        assert got.max_dupe > 1
        assert c is None or ((c == hashtable.DUPE).any() and (c == hashtable.HIGH).any())


@pytest.mark.parametrize("layout", ["kv4", "kvs", "kv16", "split"])
def test_table_layout_env_is_honoured(indexers, layout, monkeypatch):
    ix = indexers["make_panel"]
    monkeypatch.setenv("GENEFUSE_TABLE_LAYOUT", layout)
    got = tindex.build_packed_index(ix)
    _assert_equal(got, hashtable.build_packed_index(ix))
    assert _fields(got)["kind"] == ("split" if layout == "split" else "kv")
    assert tindex.layout_name(got) == layout
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


# ---------------- the single-probe packers (kvs, kv16) ----------------


def _colliders(shift, n_coll, n_other, seed):
    """n_coll keys whose h1 bucket is 5 at `shift` (their h2 elsewhere) and
    n_other keys of other buckets -> a fake indexer over them (the JAX
    kvs/kv16 tests' overflow cases)."""
    rng = np.random.default_rng(seed)
    colliders, others, seen = [], [], set()
    while len(colliders) < n_coll or len(others) < n_other:
        k = np.uint32(rng.integers(0, 2**32))
        if int(k) in seen:
            continue
        seen.add(int(k))
        ka = np.array([k], np.uint32)
        if int(hashtable.h1_np(ka, shift)[0]) == 5:
            if len(colliders) < n_coll and int(hashtable.h2_np(ka, shift)[0]) != 5:
                colliders.append(int(k))
        elif len(others) < n_other:
            others.append(int(k))
    keys = np.array(colliders + others, np.uint32)
    n = len(keys)
    return _fake_indexer(keys, (np.arange(n) % 7).astype(np.int32),
                         (np.arange(n) * 13 + 100).astype(np.int32))


def _random_keys(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32))
    m = len(keys)
    return _fake_indexer(keys, (np.arange(m) % 5).astype(np.int32),
                         (np.arange(m) * 7 + 50).astype(np.int32))


# name -> (layout, fake indexer, target_load, whether the walk runs)
SINGLE_CASES = {
    # tests/test_kvs.py:75 and tests/test_kv16.py:82: one bucket of 12 keys
    "kvs_overflow_flag": ("kvs", lambda: _colliders(26, 12, 30, 11), 1.0, False),
    "kv16_overflow_flag": ("kv16", lambda: _colliders(28, 12, 30, 7), 4.0, False),
    # tests/test_kvs.py:115: most buckets overflow, the rescue evicts; the
    # walk fails at the first bucket count, which doubles
    "kvs_high_load_eviction": ("kvs", lambda: _random_keys(200_000, 3), 4.0, True),
    # tests/test_kvs.py:248: half the buckets' keys at load 2
    "kvs_half_size": ("kvs", lambda: _random_keys(300_000, 17), 2.0, False),
    # the walk places every spill, or fails and the bucket count doubles
    "kvs_walk_places": ("kvs", lambda: _random_keys(5_000, 5_000), 3.0, True),
    "kvs_walk_fails_then_doubles": ("kvs", lambda: _random_keys(20_000, 20_000), 3.0, True),
    "kv16_walk_fails_then_places": ("kv16", lambda: _random_keys(3_000, 3_001), 12.0, True),
}


def _walks(monkeypatch):
    """Record each run of the port's `_spill_walk` (its result)."""
    from genefuserust_tpu_torch.ops import hashtable as thash

    runs, walk = [], thash._spill_walk

    def recording(*args, **kw):
        runs.append(walk(*args, **kw))
        return runs[-1]

    monkeypatch.setattr(thash, "_spill_walk", recording)
    return runs


@pytest.mark.parametrize("case", sorted(SINGLE_CASES))
def test_single_probe_packers_bit_equal_on_forced_cases(case, monkeypatch):
    layout, make, load, walk = SINGLE_CASES[case]
    ix = make()
    jax_pack = hashtable.pack_index_kvs if layout == "kvs" else hashtable.pack_index_kv16
    exp = jax_pack(ix, target_load=load)
    runs = _walks(monkeypatch)
    monkeypatch.setattr(hashtable, "_absent_key", _refuse_absent_key)
    port_pack = tindex._pack_kvs if layout == "kvs" else tindex._pack_kv16
    got = port_pack(ix, target_load=load)
    _assert_equal(got, exp)
    assert tindex.layout_name(got) == layout
    assert bool(runs) == walk, runs
    S = got.kv_tbl.shape[1] // 2
    assert (got.kv_tbl[:, 2 * S - 1] == hashtable.OVF_PAYLOAD).any()
    _assert_single_probe_invariant(got, ix.uniq_keys)


def test_single_probe_fall_through_matches_jax(indexers, monkeypatch):
    # a single-probe layout that cannot be packed falls to kv8, as in JAX
    ix = indexers["dupes"]
    for layout, jname, tname in (("kvs", "pack_index_kvs", "_pack_kvs"),
                                 ("kv16", "pack_index_kv16", "_pack_kv16")):
        with monkeypatch.context() as m:
            jpack, tpack = getattr(hashtable, jname), getattr(tindex, tname)
            m.setattr(hashtable, jname, lambda i, f=jpack: f(i, max_buckets=16))
            m.setattr(tindex, tname, lambda i, f=tpack: f(i, max_buckets=16))
            assert getattr(tindex, tname)(ix) is None
            exp = hashtable.build_packed_index(ix, layout=layout)
            got = tindex.build_packed_index(ix, layout=layout)
        _assert_equal(got, exp)
        assert tindex.layout_name(got) == "kv8" and not getattr(got, "single_probe", False)


def _assert_single_probe_invariant(p, uniq_keys):
    """Each key lies in its h1 row, or in its h2 row only where the h1 row
    is flagged; a flagged row holds the sentinel with OVF_PAYLOAD in its
    last slot; every other empty slot holds the sentinel with payload 0."""
    S = p.kv_tbl.shape[1] // 2
    keys = np.unique(np.asarray(uniq_keys).astype(np.uint32))
    tkeys, pay = p.kv_tbl[:, :S], p.kv_tbl[:, S:]
    sentinel = np.uint32(p.empty_key).view(np.int32)
    flagged = pay[:, S - 1] == hashtable.OVF_PAYLOAD
    assert (tkeys[flagged, S - 1] == sentinel).all()
    ki = keys.view(np.int32)[:, None]
    b1 = hashtable.h1_np(keys, p.shift)
    b2 = hashtable.h2_np(keys, p.shift)
    n1 = (tkeys[b1] == ki).sum(1)
    n2 = np.where((b2 != b1) & flagged[b1], (tkeys[b2] == ki).sum(1), 0)
    assert ((n1 + n2) == 1).all()
    empty = tkeys == sentinel
    marker = np.zeros_like(empty)
    marker[:, S - 1] = flagged
    assert (pay[empty & ~marker] == 0).all()
    assert (pay[~empty] != 0).all()
    assert int((~empty).sum()) == len(keys)
    assert not (keys == np.uint32(p.empty_key)).any()


@pytest.mark.parametrize("panel", ["make_panel", "dupes"])
@pytest.mark.parametrize("layout", ["kvs", "kv16"])
def test_single_probe_tables_hold_each_key_in_h1_or_past_a_flag(indexers, panel, layout):
    # the invariant the probe's single-probe variant reads: h2 only past a
    # flagged h1 row
    from genefuserust_tpu_torch.ops.hashtable import _entries_from_indexer

    p = tindex.build_packed_index(indexers[panel], layout=layout)
    assert tindex.layout_name(p) == layout
    keys = _entries_from_indexer(indexers[panel])[0]
    _assert_single_probe_invariant(p, keys)
    S = p.kv_tbl.shape[1] // 2
    flagged = p.kv_tbl[:, 2 * S - 1] == hashtable.OVF_PAYLOAD
    b1 = hashtable.h1_np(keys, p.shift)
    in_h1 = (p.kv_tbl[b1][:, :S] == keys.view(np.int32)[:, None]).any(1)
    assert flagged.any() and (~in_h1).any()  # the panel has spilled keys
