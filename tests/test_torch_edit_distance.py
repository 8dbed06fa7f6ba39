"""The port's batched Myers (plain version) against the JAX package's
`edit_distance_batch` and the host Myers, and the port's EdBatcher below
and above its threshold for the device. A Python mirror of the kernel's
wavefront (W lanes a job, lane w at iteration i on text step i - w) is
held to the same references. Integer outputs: bit-equal."""

import numpy as np
import pytest
import torch

from genefuserust_tpu.core.edit_distance import edit_distance
from genefuserust_tpu.ops import edit_distance as jed
from genefuserust_tpu_torch.ops import edit_distance as ted
from genefuserust_tpu_torch.parallel import ed_batch

BASES = "ACGTN"


def _random_pairs(seed=0, n=300):
    """tests/test_edit_distance_device.py's 300 random pairs."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        la = int(rng.integers(1, 180))
        lb = int(rng.integers(1, 180))
        a = "".join(BASES[i] for i in rng.integers(0, 5, la))
        if rng.random() < 0.5:
            b = list(a)
            for _ in range(int(rng.integers(0, 10))):
                p = int(rng.integers(0, len(b)))
                op = rng.random()
                if op < 0.4:
                    b[p] = BASES[int(rng.integers(0, 4))]
                elif op < 0.7 and len(b) > 1:
                    del b[p]
                else:
                    b.insert(p, BASES[int(rng.integers(0, 4))])
            b = "".join(b)[:lb] or "A"
        else:
            b = "".join(BASES[i] for i in rng.integers(0, 5, lb))
        pairs.append((a, b))
    return pairs


def _carry_pairs(seed=1):
    """Lengths where the add and shift carries cross words, on both sides,
    plus the empty sides."""
    rng = np.random.default_rng(seed)
    rnd = lambda L: "".join(BASES[i] for i in rng.integers(0, 4, L))
    lens = (31, 32, 33, 63, 64, 65, 96)
    pairs = [("", ""), ("", "ACGT"), ("ACGT", ""), ("A", "A"), ("A", "T"), ("", "A" * 70)]
    for la in lens:
        a = rnd(la)
        pairs.append((a, a))
        pairs.append((a, a[::-1]))
        for lb in lens:
            pairs.append((a, rnd(lb)))
    # long runs of one base drive the (Eq & Pv) + Pv carry through whole words
    pairs += [("A" * 96, "A" * 95 + "C"), ("A" * 65, "C" + "A" * 64), ("T" * 64, "T" * 33)]
    return pairs


def _encode(pairs, Lp=None, Lt=None):
    Lp = Lp or max(1, max(len(a) for a, _ in pairs))
    Lt = Lt or max(1, max(len(b) for _, b in pairs))
    B = len(pairs)
    pc, tc = np.zeros((B, Lp), np.uint8), np.zeros((B, Lt), np.uint8)
    pl, tl = np.zeros(B, np.int32), np.zeros(B, np.int32)
    for i, (a, b) in enumerate(pairs):
        pc[i, : len(a)] = ted.ED_CODE_LUT[np.frombuffer(a.encode(), np.uint8)]
        tc[i, : len(b)] = ted.ED_CODE_LUT[np.frombuffer(b.encode(), np.uint8)]
        pl[i], tl[i] = len(a), len(b)
    return pc, pl, tc, tl, max(1, (Lp + 31) // 32)


def _jax(pc, pl, tc, tl, W):
    import jax.numpy as jnp

    return np.asarray(jed.edit_distance_batch(jnp.asarray(pc), jnp.asarray(pl),
                                              jnp.asarray(tc), jnp.asarray(tl), W))


def _port(pc, pl, tc, tl, W):
    return ted.edit_distance_batch(torch.from_numpy(pc), torch.from_numpy(pl),
                                   torch.from_numpy(tc), torch.from_numpy(tl), W).numpy()


def test_alphabet_matches_jax():
    assert ted.ED_ALPHA == jed.ED_ALPHA
    assert np.array_equal(ted.ED_CODE_LUT, jed.ED_CODE_LUT)


@pytest.mark.parametrize("workload", ["random_300", "carries_and_empty"])
def test_plain_matches_jax_and_host(workload):
    pairs = _random_pairs() if workload == "random_300" else _carry_pairs()
    args = _encode(pairs)
    got = _port(*args)
    assert got.dtype == np.int32
    assert np.array_equal(got, _jax(*args))
    assert np.array_equal(got, [edit_distance(a, b) for a, b in pairs])


def test_plain_matches_jax_with_spare_words_and_padding():
    # W larger than the pattern needs and rows wider than the sequences, as
    # the batcher pads them; steps past a text's length keep their state
    pairs = _carry_pairs(seed=3)[:60]
    args = _encode(pairs, Lp=128, Lt=192)
    args = args[:4] + (6,)
    got = _port(*args)
    assert np.array_equal(got, _jax(*args))
    assert np.array_equal(got, [edit_distance(a, b) for a, b in pairs])


def test_wrapper_checks_inputs():
    pc, pl, tc, tl, W = _encode([("ACGT", "ACG")])
    t = [torch.from_numpy(x) for x in (pc, pl, tc, tl)]
    with pytest.raises(ValueError, match="words"):
        ted.edit_distance_batch(*t, 0)
    with pytest.raises(ValueError, match="int32"):
        ted.edit_distance_batch(t[0], t[1].long(), t[2], t[3], W)
    assert ted.edit_distance_batch(*t, W).tolist() == [1]


M32 = 0xFFFFFFFF


def _wavefront(pc, pl, tc, tl, W):
    """Mirror of csrc/edit_distance.cu: floor(32 / W) jobs a warp, W lanes
    a job, lane w owning word w (its 11 Eq words, Pv, Mv). At iteration i
    lane w does text step i - w, reading that step's symbol itself; the
    add's carry and hin_p / hin_m reach it, packed in one word, from lane
    w - 1's previous iteration (a shuffle up by one lane; lane 0 of a job
    starts them at 0, 1, 0). Lanes above the score's word idle; a warp
    runs to the largest steps + top_word of its jobs. uint32 in uint64
    masked."""
    B, Lp = pc.shape
    Lt = tc.shape[1]
    J = 32 // W
    nw = -(-B // J)
    lane = np.arange(32)
    g, w = lane // W, lane % W
    b = np.arange(nw)[:, None] * J + g
    live = (g < J) & (b < B)
    bb = np.where(live, b, 0)
    m = np.where(live, pl[bb], 0).astype(np.int64)
    n = np.where(live, tl[bb], 0).astype(np.int64)
    e = np.zeros((nw, 32, 11), np.uint64)
    mp = np.minimum(m, Lp) - 32 * w
    for i in range(32):
        s = np.minimum(pc[bb, np.minimum(32 * w + i, Lp - 1)], 10).astype(np.int64)
        has = live & (i < mp)
        np.put_along_axis(e, s[..., None], np.take_along_axis(e, s[..., None], 2)
                          | np.where(has, 1 << i, 0).astype(np.uint64)[..., None], 2)
    top = np.maximum(m - 1, 0)
    top_word = np.minimum(top >> 5, W - 1)
    top_bit = (1 << (top & 31)).astype(np.uint64)
    nb = np.clip(m - 32 * w, 0, 32)
    pv = ((1 << nb) - 1).astype(np.uint64)
    mv = np.zeros_like(pv)
    score = m.copy()
    steps = np.where(live & (m > 0), np.minimum(n, Lt), 0)
    works = live & (w <= top_word)
    iters = np.where(steps > 0, steps + top_word, 0).max(1)
    msg = np.zeros((nw, 32), np.uint64)
    for i in range(int(iters.max(initial=0))):
        j = i - w
        up = np.concatenate([msg[:, :1], msg[:, :-1]], 1)
        up = np.where(w == 0, 2, up).astype(np.uint64)
        sym = np.minimum(tc[bb, np.clip(j, 0, Lt - 1)], 10)
        carry, hin_p, hin_m = up & 1, (up >> 1) & 1, up >> 2
        act = (i < iters)[:, None] & works & (j >= 0) & (j < steps)
        eqw = np.take_along_axis(e, sym.astype(np.int64)[..., None], 2)[..., 0]
        xv = eqw | mv
        x = eqw & pv
        s1 = (x + pv) & M32
        s2 = (s1 + carry) & M32
        cout = ((s1 < x) | (s2 < s1)).astype(np.uint64)
        xh = (s2 ^ pv) | eqw
        ph = (mv | ~(xh | pv)) & M32
        mh = pv & xh
        delta = np.where(ph & top_bit, 1, np.where(mh & top_bit, -1, 0))
        score = np.where(act & (w == top_word), score + delta, score)
        ph_sh = ((ph << 1) & M32) | hin_p
        mh_sh = ((mh << 1) & M32) | hin_m
        pv = np.where(act, (mh_sh | ~(xv | ph_sh)) & M32, pv)
        mv = np.where(act, ph_sh & xv, mv)
        msg = np.where(act, cout | ((ph >> 31) << 1) | ((mh >> 31) << 2), msg)
    score = np.where(m == 0, n, score)
    score = np.where(n == 0, m, score)
    out = np.zeros(B, np.int32)
    at = live & (w == top_word)
    out[b[at]] = score[at]
    return out


def _edge_pairs(seed=4):
    """Pattern lengths 31-33 and 63-65 (the pattern is the shorter side
    as the batcher encodes it, but the mirror takes any), texts shorter
    and longer than the pattern, and the empty sides."""
    rng = np.random.default_rng(seed)
    rnd = lambda L: "".join(BASES[i] for i in rng.integers(0, 5, L))
    pairs = [("", ""), ("", "ACGT"), ("ACGT", ""), ("N", "N")]
    for la in (31, 32, 33, 63, 64, 65):
        a = rnd(la)
        for lb in (1, la // 2, la - 1, la, la + 1, 2 * la + 7):
            b = list(a[:lb]) + list(rnd(max(0, lb - la)))
            for _ in range(int(rng.integers(0, 4))):
                b[int(rng.integers(0, len(b)))] = BASES[int(rng.integers(0, 5))]
            pairs.append((a, "".join(b)))
            pairs.append((a, rnd(lb)))
    return pairs


@pytest.mark.parametrize("workload", ["random_300", "carries_and_empty", "edges"])
def test_wavefront_mirror_matches_jax_and_host(workload):
    pairs = {"random_300": _random_pairs, "carries_and_empty": _carry_pairs,
             "edges": _edge_pairs}[workload]()
    args = _encode(pairs)
    got = _wavefront(*args)
    assert np.array_equal(got, _jax(*args))
    assert np.array_equal(got, [edit_distance(a, b) for a, b in pairs])


@pytest.mark.parametrize("W", range(1, 11))
def test_wavefront_mirror_at_every_word_count(W):
    # patterns up to 32 W bases at each W (odd ones included), W also
    # above what the patterns need, rows wider than the sequences
    rng = np.random.default_rng(W)
    rnd = lambda L: "".join(BASES[i] for i in rng.integers(0, 5, L))
    top = 32 * W
    lens = sorted({1, 31, 32, 33, top - 1, top} & set(range(1, top + 1)))
    pairs = [(rnd(la), rnd(lb)) for la in lens for lb in (1, la // 2 + 1, la + 9)]
    pairs += [("", rnd(5)), (rnd(5), "")]
    args = _encode(pairs, Lp=top, Lt=top + 20)[:4] + (W,)
    got = _wavefront(*args)
    assert np.array_equal(got, _jax(*args))
    assert np.array_equal(got, _port(*args))
    assert np.array_equal(got, [edit_distance(a, b) for a, b in pairs])


def test_wavefront_mirror_with_text_longer_than_its_row():
    # a text length above Lt: steps stop at the row's end, as in JAX
    pairs = _carry_pairs(seed=5)[:40]
    pc, pl, tc, tl, W = _encode(pairs)
    tl = tl + 17
    got = _wavefront(pc, pl, tc, tl, W)
    assert np.array_equal(got, _jax(pc, pl, tc, tl, W))
    assert np.array_equal(got, _port(pc, pl, tc, tl, W))


def _jobs(n, seed):
    """n mutated pairs of 90-160 bases (some truncated, some lowercase),
    four of them replaced by jobs that must stay on the host: an exotic
    byte, an empty text, an empty pattern and a character outside latin-1."""
    rng = np.random.default_rng(seed)
    jobs = []
    for k in range(n):
        a = "".join(BASES[i] for i in rng.integers(0, 5, int(rng.integers(90, 160))))
        b = list(a)
        for _ in range(int(rng.integers(0, 5))):
            b[int(rng.integers(0, len(b)))] = BASES[int(rng.integers(0, 4))]
        b = "".join(b)
        if k % 3 == 0:
            b = b[: len(b) - int(rng.integers(1, 30))]
        if k % 5 == 1:
            a = a.lower()  # lowercase is its own symbol
        jobs.append((a, b))
    special = [("ACGTACGTRACGT", "ACGTACGTACGT"), ("ACGT", ""), ("", "ACGT"),
               ("ACGT\u03a9ACGT", "ACGTACGT")]
    if n >= len(special):
        for i, job in enumerate(special):
            jobs[i * n // len(special)] = job
    return jobs


def _run_batcher(jobs, device):
    stats = {"jobs": 0, "device_sized": 0, "device": 0}
    b = ed_batch.EdBatcher(stats, device=device)
    got = [None] * len(jobs)
    for i, (q, r) in enumerate(jobs):
        b.submit(q, r, lambda v, i=i: got.__setitem__(i, v))
    assert len(b) == len(jobs)
    b.flush()
    assert len(b) == 0
    return got, stats


def _check_batcher(n, device):
    jobs = _jobs(n, seed=n)
    got, stats = _run_batcher(jobs, device)
    assert got == [edit_distance(q, r) for q, r in jobs]
    assert stats["jobs"] == n
    big = n >= ed_batch.min_jobs(device)
    assert stats["device_sized"] == (n if big else 0)
    # the four special jobs stayed on the host
    assert stats["device"] == (n - (4 if n >= 4 else 0) if big else 0)


@pytest.mark.parametrize("n", [1, 2, 27, ed_batch.CPU_MIN_JOBS - 1, ed_batch.CPU_MIN_JOBS,
                               ed_batch.CPU_MIN_JOBS + 21])
def test_ed_batcher_equals_host(n):
    _check_batcher(n, "cpu")


def test_ed_batcher_threshold_follows_the_device():
    # the batcher reads its threshold from the device type alone; a CUDA
    # device object needs no card
    assert ed_batch.EdBatcher({}, device="cpu").min_jobs == ed_batch.CPU_MIN_JOBS
    assert ed_batch.EdBatcher({}, device="cuda").min_jobs == ed_batch.DEVICE_MIN_JOBS
    assert 1 < ed_batch.DEVICE_MIN_JOBS < ed_batch.CPU_MIN_JOBS


@pytest.mark.parametrize("lo,hi", [(80, 110), (100, 300)])
def test_ab_jobs_are_batched_and_equal_host(lo, hi):
    # the A/B script's and phase 9's jobs: all go to the kernel, whose plain
    # version equals host Myers on them
    from genefuserust_tpu_torch.profiling.ed_ab import ed_jobs

    jobs = ed_jobs(40, seed=3, lo=lo, hi=hi)
    assert all(lo <= len(a) <= hi for a, _ in jobs)
    assert any(a != b for a, b in jobs)
    host, arrays = ed_batch.encode_jobs(jobs)
    assert not host.any()
    args = [torch.from_numpy(x) for x in arrays]
    got = ted.edit_distance_batch(*args, args[0].shape[1] // 32)
    assert got.tolist() == [edit_distance(a, b) for a, b in jobs]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["random_300", "carries_and_empty", "edges"])
@pytest.mark.parametrize("W_extra", [0, 3, 20])
def test_ed_kernel_matches_plain(workload, W_extra, cuda_device):
    pairs = {"random_300": _random_pairs, "carries_and_empty": _carry_pairs,
             "edges": _edge_pairs}[workload]()
    pc, pl, tc, tl, W = _encode(pairs)
    W += W_extra
    cpu = [torch.from_numpy(x) for x in (pc, pl, tc, tl)]
    got = ted.edit_distance_batch(*(x.to(cuda_device) for x in cpu), W)
    assert torch.equal(got.cpu(), ted.edit_distance_batch(*cpu, W))


@pytest.mark.cuda
@pytest.mark.parametrize("W", [*range(1, 11), 31, 32])
def test_ed_kernel_matches_plain_at_every_word_count(W, cuda_device):
    rng = np.random.default_rng(W)
    rnd = lambda L: "".join(BASES[i] for i in rng.integers(0, 5, L))
    top = 32 * W
    lens = sorted({1, 31, 32, 33, 63, 64, 65, top - 1, top} & set(range(1, top + 1)))
    pairs = [(rnd(la), rnd(lb)) for la in lens for lb in (1, la // 2 + 1, la + 9)]
    pairs += [("", rnd(5)), (rnd(5), "")] * 40
    pc, pl, tc, tl, _ = _encode(pairs, Lp=top, Lt=top + 20)
    tl[::7] += 25  # texts longer than their rows
    cpu = [torch.from_numpy(x) for x in (pc, pl, tc, tl)]
    got = ted.edit_distance_batch(*(x.to(cuda_device) for x in cpu), W)
    assert torch.equal(got.cpu(), ted.edit_distance_batch(*cpu, W))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [-1, 0, 21])
def test_ed_batcher_on_cuda_equals_host(offset, cuda_device):
    _check_batcher(ed_batch.DEVICE_MIN_JOBS + offset, cuda_device)
