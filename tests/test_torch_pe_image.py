"""The PE-matmul probes' arithmetic, P image and plan on the CPU.

``csrc/anatomy_pe.cu:pe_mm_hopper_kernel<TERMS>`` runs ``pe_mm`` (TERMS =
3) as six bf16 wgmma passes over a three-term split of each operand and
``pe_mm_bf16`` (TERMS = 1) as one pass over operands rounded to bf16, with
P read from an image that ``ops/anatomy.py:pe_image`` lays out.  The kernel
runs only on a card (``tests/test_torch_cuda.py``); here are the split, a
plain model of the passes, the image and the plan, exactly.

The split (``split_terms``): hi is x with the low 16 bits of its f32
pattern cleared, mid the same of x - hi, lo = x - hi - mid.  Truncation
keeps the three terms on x's sign and within 24 bits below hi's leading
bit, so they sum back to x with no carry.  The documented limit: once x's
exponent is under -103, lo can fall under f32's normal range and stop
being a bf16 value; and x = ±inf splits into ±inf, NaN, NaN.

The model sums each pass's products over k16 steps, exactly, and rounds
into an f32 accumulator once a step, passes in the kernel's order.  For a
dense P the error against a float64 product is stated in units of 2^-24
sum_k |x_k P_kc|: the model reads ~1.7, a truncating accumulator ~3, a plain
f32 matmul ~5; a missing or doubled pass is over 100.  The bound is 16.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_fl_torch.ops import anatomy
from nerf_fl_torch.ops import fused_mlp as fm

CSRC = Path(fm.__file__).resolve().parent.parent / "csrc"
PE_DENSE = 16.0                      # units of 2^-24 sum_k |x_k P_kc|
BF, F32 = torch.bfloat16, torch.float32


def _bits(x):
    return x.view(torch.int32)


def _is_bf16(t):
    return torch.equal(_bits(t.to(BF).float()), _bits(t))


def _edges():
    """±0, powers of two, x with all 23 mantissa bits (and so all low 16)
    set, the f32 max, and those over the exponents where the split holds."""
    e = torch.arange(-103, 128, dtype=torch.float64)
    p2 = torch.pow(2.0, e)
    full = (2.0 - 2.0 ** -23) * p2             # every mantissa bit set
    low16 = (1.0 + (2.0 ** 16 - 1) * 2.0 ** -23) * p2   # the low 16 bits set
    vals = torch.cat([p2, full, low16]).float()
    vals = torch.cat([vals, -vals, torch.tensor([0.0, -0.0])])
    assert torch.isfinite(vals).all()
    assert float(vals.max()) == float(torch.finfo(F32).max)
    return vals


def test_split_is_exact_for_normal_draws():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, 100_000)
                         .astype(np.float32))
    hi, mid, lo = anatomy.split_terms(x)
    assert torch.equal(_bits(hi + mid + lo), _bits(x))
    assert torch.equal(_bits(lo + mid + hi), _bits(x))   # the kernel's order
    for t in (hi, mid, lo):
        assert _is_bf16(t)
    # one sign: no term opposes x
    assert not ((hi * x < 0) | (mid * x < 0) | (lo * x < 0)).any()


def test_split_is_exact_at_the_edges():
    x = _edges()
    hi, mid, lo = anatomy.split_terms(x)
    # bit for bit but for -0, whose terms (-0, +0, +0) sum to +0
    nz = x != 0
    for got in (hi + mid + lo, lo + mid + hi):
        assert torch.equal(got, x)
        assert torch.equal(_bits(got[nz]), _bits(x[nz]))
    for t in (hi, mid, lo):
        assert _is_bf16(t)
    # ±0 and powers of two are their own hi
    z = torch.tensor([0.0, -0.0, 1.0, -2.0 ** -103, 2.0 ** 127])
    hz, mz, lz = anatomy.split_terms(z)
    assert torch.equal(_bits(hz), _bits(z))
    assert not mz.any() and not lz.any()
    # the f32 max: hi keeps its top 8 significant bits, mid the next 8
    m = torch.tensor([torch.finfo(F32).max])
    hm, mm, lm = anatomy.split_terms(m)
    assert float(hm) == (2 - 2 ** -7) * 2.0 ** 127
    assert float(mm) == (2 ** -7 - 2 ** -15) * 2.0 ** 127
    assert float(lm) == (2 ** -15 - 2 ** -23) * 2.0 ** 127


def test_split_documented_limit_below_2_to_the_minus_103():
    """With every mantissa bit set, lo is 2^(e-15) (2 - 2^-7): its last bit
    2^(e-23) is still normal at e = -103.  At e = -111 it is a subnormal
    whose bits lie in the low 16 of its pattern, so lo is no bf16 value
    (the sum stays exact in f32, the kernel's bf16 term does not)."""
    ok = torch.tensor([(2.0 - 2.0 ** -23) * 2.0 ** -103])
    _, _, lo = anatomy.split_terms(ok)
    assert float(lo) >= torch.finfo(F32).tiny and _is_bf16(lo)
    bad = torch.tensor([(2.0 - 2.0 ** -23) * 2.0 ** -111])
    hi, mid, lo = anatomy.split_terms(bad)
    assert torch.equal(_bits(hi + mid + lo), _bits(bad))
    assert 0 < float(lo) < torch.finfo(F32).tiny and not _is_bf16(lo)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_split_of_an_infinite_input_is_nan_past_hi(sign):
    """The other documented limit: x = ±inf splits into ±inf, NaN, NaN
    (x - hi is inf - inf), so the six passes give NaN in a row where x @ P
    gives ±inf, at the probe's P."""
    inf = torch.tensor([sign * float("inf")])
    hi, mid, lo = anatomy.split_terms(inf)
    assert torch.equal(hi, inf) and mid.isnan().all() and lo.isnan().all()
    P = anatomy.pe_mm_rows()[0]
    x = torch.ones(2, 128)
    x[0, 0] = inf
    want = x @ P
    got = six_pass_model(x, P)
    hit = P[0] != 0
    assert torch.equal(want[0, hit], (sign * P[0, hit]).sign() * inf.abs())
    assert got[0].isnan().all()
    assert torch.equal(got[1], want[1])


def six_pass_model(x, P, passes=anatomy.PE_PASSES):
    """The kernel's arithmetic, plainly: both operands split, each pass's
    products summed exactly over a k16 step and rounded into one f32
    accumulator, passes in the kernel's order."""
    xs, ps = anatomy.split_terms(x), anatomy.split_terms(P)
    acc = torch.zeros(x.shape[0], P.shape[1], dtype=F32)
    for i, j in passes:
        a, p = xs[i].double(), ps[j].double()
        for k in range(0, x.shape[1], 16):
            acc = (acc.double() + a[:, k:k + 16] @ p[k:k + 16]).float()
    return acc


def _dense(seed=0, n=2048):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (n, 128)).astype(np.float32))
    P = torch.from_numpy(rng.normal(0, 1, (128, 128)).astype(np.float32))
    return x, P


def _units(E, x, P):
    """max |E - x @ P (float64)| in units of 2^-24 sum_k |x_k P_kc|."""
    ref = x.double() @ P.double()
    unit = 2.0 ** -24 * (x.double().abs() @ P.double().abs())
    return float(((E.double() - ref).abs() / unit).max())


def test_six_pass_model_is_x_at_P_bit_for_bit_at_the_probes_P():
    P = anatomy.pe_mm_rows()[0]
    assert torch.equal(_bits(anatomy.split_terms(P)[0]), _bits(P))  # mid, lo 0
    x = torch.cat([anatomy.chain_operands(512, 0)["x128"],
                   _edges()[:128 * 4].reshape(4, 128),
                   anatomy.chain_operands(64, 7)["x128"] * 50.0])
    # E reaches 2^127 * 2^9 at the largest edges: those overflow on both
    # sides alike; bit for bit wherever x @ P is finite
    ref = x @ P
    got = six_pass_model(x, P)
    fin = torch.isfinite(ref)
    assert fin.float().mean() > 0.9
    assert torch.equal(_bits(got[fin]), _bits(ref[fin]))


@pytest.mark.parametrize("seed", [0, 1])
def test_six_pass_model_on_a_dense_P_is_within_the_bound(seed):
    x, P = _dense(seed)
    assert _units(six_pass_model(x, P), x, P) <= PE_DENSE


@pytest.mark.parametrize("change", ["missing", "doubled"])
@pytest.mark.parametrize("k", range(6))
def test_a_missing_or_doubled_pass_fails_the_bound(change, k):
    x, P = _dense(2, n=512)
    passes = list(anatomy.PE_PASSES)
    passes = passes[:k] + passes[k + 1:] if change == "missing" \
        else passes + [passes[k]]
    assert _units(six_pass_model(x, P, passes), x, P) > PE_DENSE


def test_passes_are_the_kernels_order():
    """``PASSES`` in the source, as (A term, B term) hex digit pairs, first
    pass leftmost, is ``PE_PASSES``: the cross products with i + j <= 2,
    each once, smallest first; pe_mm_bf16 (one pass) runs (hi, hi)."""
    src = (CSRC / "anatomy_pe.cu").read_text()
    digits = re.search(r"constexpr unsigned long long PASSES = 0x([0-9a-f]+)"
                       r"ull;", src).group(1)
    got = tuple((int(digits[2 * p]), int(digits[2 * p + 1]))
                for p in range(len(digits) // 2))
    assert got == anatomy.PE_PASSES
    assert sorted(got) == sorted((i, j) for i in range(3) for j in range(3)
                                 if i + j <= 2)
    assert [i + j for i, j in got] == [2, 2, 2, 1, 1, 0]
    assert "return terms == 1 ? 1 : N_PASS_ALL;" in src
    assert anatomy.PE_TERMS == {"pe_mm": 3, "pe_mm_bf16": 1}


def _decode(image, terms):
    """Every term of P back as its (128, 128) matrix, through the swizzle:
    element (image row i, contraction value 8 c + e) of a slab is at
    [slab][i][c ^ (i % 8)][e]."""
    slabs, _ = anatomy.pe_image_plan(terms)
    flat = image.view(torch.int16).numpy()
    out = [np.zeros((128, 128), np.int16) for _ in range(terms)]
    i = np.arange(128)[:, None, None]
    c = np.arange(8)[None, :, None]
    e = np.arange(8)[None, None, :]
    for sl in slabs:
        at = sl.at // 2 + i * 64 + 8 * (c ^ (i % 8)) + e        # (128, 8, 8)
        out[sl.layer][sl.row0:sl.row0 + 64, :] = flat[at].reshape(128, 64).T
    return [torch.from_numpy(m).view(BF) for m in out]


def test_pe_plan_is_two_16_kb_slabs_a_term():
    for terms in (1, 3):
        slabs, nbytes = anatomy.pe_image_plan(terms)
        assert nbytes == terms * 32768 and len(slabs) == 2 * terms
        assert [s.at for s in slabs] == [16384 * j for j in range(2 * terms)]
        assert [(s.layer, s.row0) for s in slabs] == [
            (t, r) for t in range(terms) for r in (0, 64)]
        assert all(s.height == 128 and s.rows == 64 and s.cols == 128
                   and not s.dgrad for s in slabs)


@pytest.mark.parametrize("terms", [1, 3])
def test_pe_image_decodes_to_each_term(terms):
    rng = np.random.default_rng(terms)
    P = torch.from_numpy(rng.normal(0, 1, (128, 128)).astype(np.float32))
    image = anatomy.pe_image(P, terms)
    assert image.dtype == BF and image.numel() == terms * 128 * 128
    idx = anatomy._pe_index(terms)
    assert np.array_equal(np.sort(idx), np.arange(terms * 128 * 128))
    got = _decode(image, terms)
    want = [t.to(BF) for t in anatomy.split_terms(P)] if terms == 3 \
        else [P.to(BF)]
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16), w.view(torch.int16))
    if terms == 3:                        # the terms sum back to P
        assert torch.equal(got[2].float() + got[1].float() + got[0].float(),
                           P)
    # one element by hand: term 1 of P[100, 5] is in slab 2 * 1 + 100 // 64,
    # image row 5, chunk (100 % 64) // 8 ^ 5 % 8
    at = (2 * (terms - 1) + 1) * 8192 + 5 * 64 + 8 * ((36 // 8) ^ 5) + 36 % 8
    assert image[at].view(torch.int16) == want[-1][100, 5].view(torch.int16)


def test_pe_plan_is_the_kernels_walk():
    """``make_pe_plan`` in the source: one ``plan_seg`` of 128 rows and 128
    image rows a term, so two slabs of 16 KB a term, in term order.  The
    card's build is compared with the Python plan at the first launch
    (``ops/anatomy.py:_check_pe_plan``) and by tests/test_torch_cuda.py."""
    src = (CSRC / "anatomy_pe.cu").read_text()
    body = re.search(r"inline int make_pe_plan\(Plan& p, int terms\) \{(.*?)"
                     r"\n\}", src, re.S).group(1)
    assert re.findall(r"plan_seg\(p, at, (.*?), (\w+)\);", body) \
        == [("LANES", "LANES")]
    assert "for (int j = 0; j < terms; ++j)" in body
    assert re.search(r"constexpr int LANES = (\d+);", src).group(1) == "128"
    for terms in (1, 3):
        off, at = [], 0
        for _ in range(terms):
            for _ in range(0, 128, 64):
                off.append(at)
                at += 128 * 128
        slabs, nbytes = anatomy.pe_image_plan(terms)
        assert off == [s.at for s in slabs] and at == nbytes


@pytest.mark.parametrize("terms,smem", [(3, 199_176), (1, 68_104)])
def test_pe_shared_memory_budget(terms, smem):
    """1024 bytes of alignment slack, two warpgroups' operand tiles (TERMS
    terms x 2 tiles of 8 KB), P's image (TERMS x 32 KB), ph / trg / s (3 x
    512 B) and one barrier: 199,176 B for pe_mm (one block an SM) and 68,104
    for pe_mm_bf16 (three fit by shared memory), under the 232,448 bytes a
    block can have.  The source's own reckoning is the same sum."""
    assert 1024 + 2 * terms * 2 * 8192 + terms * 32768 + 3 * 512 + 8 == smem
    assert smem <= 232_448
    assert 3 * (smem + 1024) <= 233_472 or terms == 3
    src = (CSRC / "anatomy_pe.cu").read_text()
    body = re.search(r"constexpr int smem_bytes\(int terms\) \{(.*?)\n\}",
                     src, re.S).group(1)
    assert "1024 + CONSUMERS * terms * K_TILES * TILE_BYTES" in body
    assert "terms * TERM_BYTES" in body and "EPI_FLOATS * 4 + 8" in body


@pytest.mark.parametrize("name", ["pe_mm", "pe_mm_bf16"])
def test_pe_scratch_is_the_image_of_P(name, monkeypatch):
    """Each wrapper checks its own variant's plan against the card's build
    (stubbed here: there is no card) and hands the kernel P's image."""
    checked = []
    monkeypatch.setattr(anatomy, "_check_pe_plan", checked.append)
    terms = anatomy.PE_TERMS[name]
    ops = anatomy.pe_mm_rows() + [anatomy.chain_operands(8, 0)["x128"]]
    image = anatomy.PROBES[name].scratch(ops)
    assert checked == [terms]
    assert torch.equal(image.view(torch.int16),
                       anatomy.pe_image(ops[0], terms).view(torch.int16))
