"""The port's table probe (kernel 1's plain version) against the JAX
package: `pallas_lookup` in interpret mode for the split layout, and
`kv_lookup` / `hash_lookup` for the kv2, kv4, kv8 and split tables. All
outputs are integers, so equal means bit-equal."""

import numpy as np
import pytest
import torch

from genefuserust_tpu.config import Settings
from genefuserust_tpu.core.indexer import Indexer
from genefuserust_tpu.models.fusion import Fusion
from genefuserust_tpu.ops.hashtable import (
    EMPTY,
    h1_np,
    h2_np,
    pack_index,
    pack_index_kv,
    pack_index_kv16,
    pack_index_kvs,
)
from genefuserust_tpu.utils.synthetic import make_panel, write_panel_files
from genefuserust_tpu_torch.ops import map_read as tm
from genefuserust_tpu_torch.ops.index import index_to_torch

# layout -> pack_index_kv arguments (kv8 is the packer's default)
KV_LAYOUTS = {
    "kv2": dict(target_load=0.5, slots=1),
    "kv4": dict(target_load=0.6, slots=2),
    "kv8": dict(),
}


def dupe_panel():
    """make_panel with a 28 bp motif planted 3x in GENE1 (dupe entries) and
    8x in GENE2 (high-level dupes)."""
    panel = make_panel(seed=11)
    motif = "ACGTTGCAACGGTTACGATCCAGTTACG"
    for (_, chrom, start, _), offs in zip(
        panel.genes, ([1000, 3000, 7000], [500 + 1100 * k for k in range(8)])
    ):
        s = panel.contigs[chrom]
        for off in offs:
            s = s[: start + off] + motif + s[start + off + len(motif) :]
        panel.contigs[chrom] = s
    return panel


@pytest.fixture(scope="module")
def indexer(tmp_path_factory):
    panel = dupe_panel()
    _, csv_path = write_panel_files(panel, str(tmp_path_factory.mktemp("panel")))
    ix = Indexer(panel.contigs, Fusion.parse_csv(csv_path), Settings())
    ix.make_index()
    return ix


def _queries(ix, n, seed):
    """Half real keys, half random 32-bit values (about half >= 2^31)."""
    rng = np.random.default_rng(seed)
    real = rng.choice(np.asarray(ix.uniq_keys), size=n // 2).astype(np.uint32)
    miss = rng.integers(0, 2**32, n - n // 2, dtype=np.uint64).astype(np.uint32)
    q = np.concatenate([real, miss])
    rng.shuffle(q)
    assert (q >= 2**31).sum() > n // 8
    return q


def _as_i32(q):
    return q.astype(np.uint32).view(np.int32)


def test_buckets_match_numpy_hashes():
    rng = np.random.default_rng(1)
    k = rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32)
    k[:4] = [0, 2**31, 2**32 - 1, 0x9E3779B1]
    for shift in (4, 12, 26, 28):
        b1, b2 = tm.buckets(torch.from_numpy(k.astype(np.int64)), shift)
        assert (b1.numpy() == h1_np(k, shift)).all()
        assert (b2.numpy() == h2_np(k, shift)).all()


def test_probe_matches_pallas_lookup(indexer):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.pallas_lookup import TILE, pallas_lookup

    packed = pack_index(indexer)
    q = _as_i32(_queries(indexer, TILE, seed=0))
    got = tm.probe_kmers(
        torch.from_numpy(q), torch.ones(TILE, dtype=torch.bool),
        index_to_torch(packed, "cpu"),
    ).numpy()
    exp = np.asarray(
        pallas_lookup(
            jnp.asarray(q), jnp.asarray(packed.keys_tbl),
            jnp.asarray(packed.vals_tbl), packed.shift, interpret=True,
        )
    )
    assert (got == exp).all()
    assert (got[:, 0] != EMPTY).sum() >= TILE // 2


def test_probe_matches_hash_lookup_with_invalid(indexer):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import hash_lookup

    packed = pack_index(indexer)
    q = _queries(indexer, 6000, seed=2)
    valid = np.random.default_rng(3).random(q.shape) < 0.8
    c, p = hash_lookup(
        (jnp.asarray(packed.keys_tbl), jnp.asarray(packed.vals_tbl)),
        packed.shift, jnp.asarray(q), jnp.asarray(valid),
    )
    got = tm.probe_kmers(
        torch.from_numpy(_as_i32(q)), torch.from_numpy(valid),
        index_to_torch(packed, "cpu"),
    ).numpy()
    assert (got[:, 0] == np.asarray(c)).all()
    assert (got[:, 1] == np.asarray(p)).all()
    assert (got[~valid, 0] == EMPTY).all()


@pytest.mark.parametrize("layout", sorted(KV_LAYOUTS))
def test_probe_matches_kv_lookup(indexer, layout):
    import jax.numpy as jnp

    from genefuserust_tpu.ops.map_read import kv_lookup

    packed = pack_index_kv(indexer, **KV_LAYOUTS[layout])
    assert packed is not None
    assert packed.kv_tbl.shape[1] == {"kv2": 2, "kv4": 4, "kv8": 8}[layout]
    q = _queries(indexer, 6000, seed=4)
    valid = np.random.default_rng(5).random(q.shape) < 0.85
    c, p = kv_lookup(
        jnp.asarray(packed.kv_tbl), packed.shift, packed.cbits, packed.pos_bias,
        jnp.asarray(q), jnp.asarray(valid),
    )
    c, p = np.asarray(c), np.asarray(p)
    got = tm.probe_kmers(
        torch.from_numpy(_as_i32(q)), torch.from_numpy(valid),
        index_to_torch(packed, "cpu"),
    ).numpy()
    assert (got[:, 0] == c).all()
    # JAX leaves the pos of an invalid query as whatever its row-0 probe
    # decoded (the engine never reads it, contig is EMPTY); the port makes
    # no load for an invalid query and reports pos 0
    hit = c != EMPTY
    assert (got[hit, 1] == p[hit]).all()
    assert (got[~valid, 1] == 0).all()
    # regular hits, dupes and high dupes are all exercised
    assert (c >= 0).any() and (c == -1).any() and (c == -2).any()


@pytest.mark.parametrize("packer", [pack_index_kvs, pack_index_kv16])
def test_single_probe_layouts_are_refused(indexer, packer):
    packed = packer(indexer)
    assert packed is not None
    with pytest.raises(NotImplementedError, match="kvs and kv16"):
        index_to_torch(packed, "cpu")


def test_probe_wrapper_checks_inputs(indexer):
    index = index_to_torch(pack_index(indexer), "cpu")
    codes = torch.zeros((4, 40), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32"):
        tm.probe(codes, torch.zeros(4, dtype=torch.int64), 2, index)
    with pytest.raises(ValueError, match="contiguous"):
        tm.probe(codes[:, ::2], torch.zeros(4, dtype=torch.int32), 2, index)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["split", *sorted(KV_LAYOUTS)])
def test_probe_kernel_matches_plain(indexer, layout, cuda_device):
    packed = (pack_index(indexer) if layout == "split"
              else pack_index_kv(indexer, **KV_LAYOUTS[layout]))
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 4, (300, 192), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 255
    lengths = rng.integers(0, 193, 300).astype(np.int32)
    q = _queries(indexer, 5000, seed=7)
    valid = rng.random(q.shape) < 0.9
    cpu, dev = index_to_torch(packed, "cpu"), index_to_torch(packed, cuda_device)
    for stride in (1, 2):
        exp = tm.probe(torch.from_numpy(codes), torch.from_numpy(lengths), stride, cpu)
        got = tm.probe(torch.from_numpy(codes).to(cuda_device),
                       torch.from_numpy(lengths).to(cuda_device), stride, dev)
        assert torch.equal(got.cpu(), exp)
    args = (torch.from_numpy(_as_i32(q)), torch.from_numpy(valid))
    exp = tm.probe_kmers(*args, cpu)
    got = tm.probe_kmers(*(a.to(cuda_device) for a in args), dev)
    assert torch.equal(got.cpu(), exp)
