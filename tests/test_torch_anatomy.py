"""The kernel-anatomy probes of the port against the JAX files' Pallas kernels.

The Pallas probe kernels are closures inside ``main()`` of
``experiments/kernel_anatomy.py`` and ``kernel_anatomy2.py``, written for a
TPU.  ``_run_jax_file`` runs them on the CPU with the files untouched: it
loads a file by path, sets its module globals ``N`` (4,096 points: two
tiles) and replaces ``run`` / ``run_kernel`` by one that makes the same
``pl.pallas_call`` with ``interpret=True`` and records the kernel's name,
operands and output, and ``bench`` by one that calls the function once under
``jax.disable_jit()`` and writes nothing (the original rewrites the TPU
record ``experiments/anatomy*_results.json``).

On the CPU the port's probes run their plain versions; the CUDA kernels are
held to those on the card (``chip_smoke.py`` phase 8,
``tests/test_torch_cuda.py``).

Tolerances:
  * bf16 kernels (chain8, concat, split, static, full, consol): ``|d| <=
    4e-3 + 1e-2 |ref|`` and mean ``|d| <= 5e-5``.  Both sides sum the same
    exact products in f32 in another order, which flips single bf16
    roundings of a hidden value (one ulp, 2^-8 relative), and the later
    layers carry them on.  Measured here: max 2.0e-3 (one bf16 ulp of an
    output near 0.5), mean 2.6e-6, outputs up to 1.23.  (The card's gate,
    kernel against plain at 524,288 points in ``chip_smoke.py``, is the
    same.)
  * pe_kernel: ``atol 1e-5``; measured 1.1e-6 on outputs up to 7.7.
  * the four PE probes restated in jnp: ``|d| <= 1e-5 + 2^-23 |arg|``,
    ``arg`` the sin's argument (up to 2^9 |x|).  E and the argument are
    exact on both sides, and two f32 sin implementations good to an ulp
    agree to 1e-7; the second term allows one whose range reduction is only
    good to an ulp of the argument, which one run of XLA's CPU sin here
    showed (1.5e-4 at arguments near 2,000; 7e-8 in every other run).
    pe_mm equals pe_vpu exactly.
"""
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from nerf_fl_torch.experiments import kernel_anatomy as ka
from nerf_fl_torch.experiments import kernel_anatomy2 as ka2
from nerf_fl_torch.ops import anatomy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096
BF16_ATOL, BF16_RTOL, BF16_MEAN = 4e-3, 1e-2, 5e-5
F32_ATOL = 1e-5
RECORDS = [os.path.join(ROOT, "experiments", f)
           for f in ("anatomy_results.json", "anatomy2_results.json")]


def _run_jax_file(name):
    """Run ``experiments/<name>.py``'s ``main()`` in interpret mode.
    Returns ({kernel name: (operands, output)} as numpy-convertible jax
    arrays, the exception ``main()`` ended with or None)."""
    path = os.path.join(ROOT, "experiments", name + ".py")
    spec = importlib.util.spec_from_file_location("_anatomy_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    saved_path = list(sys.path)
    try:
        spec.loader.exec_module(mod)        # the file prepends "." itself
    finally:
        sys.path[:] = saved_path
    mod.N = N
    recorded = {}

    def run(kernel, ins, in_specs, out_cols, sem=None):
        out = pl.pallas_call(
            kernel, grid=(N // mod.T,), in_specs=in_specs,
            out_specs=mod.tile_spec(out_cols),
            out_shape=jax.ShapeDtypeStruct((N, out_cols), jnp.float32),
            interpret=True)(*ins)
        recorded[kernel.__name__] = (list(ins), out)
        return out

    def bench(name, f, *args, k=None):
        with jax.disable_jit():
            f(*args)

    mod.run = mod.run_kernel = run
    mod.bench = bench
    err = None
    try:
        mod.main()
    except TypeError as e:                  # kernel_anatomy.py:145, see below
        err = e
    return recorded, err


@pytest.fixture(scope="module")
def jax_runs():
    before = [open(p, "rb").read() for p in RECORDS]
    runs = {name: _run_jax_file(name)
            for name in ("kernel_anatomy", "kernel_anatomy2")}
    assert [open(p, "rb").read() for p in RECORDS] == before
    return runs


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t):
    """Bit pattern of a torch tensor or a jax array, as a numpy array."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().view(np.uint32)
    a = np.asarray(t)
    return a.view(np.uint16 if a.dtype == jnp.bfloat16 else np.uint32)


def _assert_bf16_close(got, ref):
    d = np.abs(got - ref)
    assert (d <= BF16_ATOL + BF16_RTOL * np.abs(ref)).all(), d.max()
    assert d.mean() <= BF16_MEAN, d.mean()


# Pallas kernel -> (file, the port's probe)
PALLAS = {"chain8_kernel": ("kernel_anatomy", "chain8"),
          "concat_kernel": ("kernel_anatomy", "concat"),
          "split_kernel": ("kernel_anatomy", "split"),
          "static_kernel": ("kernel_anatomy2", "static"),
          "full_kernel": ("kernel_anatomy2", "full"),
          "pe_kernel": ("kernel_anatomy2", "pe_only"),
          "consol_kernel": ("kernel_anatomy2", "consol")}


@pytest.mark.parametrize("kernel", sorted(PALLAS))
def test_probe_matches_pallas_kernel(jax_runs, kernel):
    """The recorded operands of the Pallas kernel, run in interpret mode,
    through the port's probe: same output within the stated tolerance."""
    file, probe = PALLAS[kernel]
    ins, ref = jax_runs[file][0][kernel]
    got = anatomy.PROBES[probe](*[_to_torch(a) for a in ins]).numpy()
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (N, 128) and np.isfinite(got).all()
    if kernel == "pe_kernel":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
    else:
        _assert_bf16_close(got, ref)


def test_stale_call_in_the_jax_file_still_raises(jax_runs):
    """``kernel_anatomy.py:145`` passes ``_encoder_consts`` a fourth
    argument it no longer takes, so the JAX file stops after its chain
    probes; the port's ``pe_mm_rows`` stands in for that line.  If this
    fails the JAX file was repaired: hold the four PE probes to it too."""
    recorded, err = jax_runs["kernel_anatomy"]
    assert isinstance(err, TypeError) and "_encoder_consts" in str(err)
    assert set(recorded) == {"chain8_kernel", "concat_kernel", "split_kernel"}
    assert jax_runs["kernel_anatomy2"][1] is None


def test_chain_operands_equal_the_jax_draws(jax_runs):
    """Seed 0 through the port's maker: bit for bit the JAX file's operands
    (bf16 compared as bit patterns)."""
    ins, _ = jax_runs["kernel_anatomy"][0]["split_kernel"]
    mine = anatomy.chain_inputs(anatomy.chain_operands(N, 0), True)
    assert len(mine) == len(ins) == 18
    for a, b in zip(mine, ins):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    ins8, _ = jax_runs["kernel_anatomy"][0]["chain8_kernel"]
    for a, b in zip(anatomy.chain_inputs(anatomy.chain_operands(N, 0), False),
                    ins8):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kernel,variant", [("static_kernel", "static"),
                                            ("full_kernel", "full"),
                                            ("consol_kernel", "consol")])
def test_net_operands_equal_the_jax_draws(jax_runs, kernel, variant):
    ins, _ = jax_runs["kernel_anatomy2"][0][kernel]
    mine = anatomy.net_inputs(anatomy.net_operands(N, 0), variant)
    assert len(mine) == len(ins)
    for a, b in zip(mine, ins):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_encoder_operands_equal_the_jax_draws(jax_runs):
    """The nine encoder rows and the f32 input drawn last (``:175``)."""
    ins, _ = jax_runs["kernel_anatomy2"][0]["pe_kernel"]
    mine = anatomy.encoder_rows() + [anatomy.net_operands(N, 0)["inp"]]
    assert len(mine) == len(ins) == 10
    for a, b in zip(mine, ins):
        assert tuple(a.shape) == np.asarray(b).shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


# the four PE probes of kernel_anatomy.py that the stale line keeps from
# running, bodies restated from :151-193 (T rows at once instead of a tile)
def _jnp_pe_out(E, ph, trg, s):
    return jnp.where(trg > 0, jnp.sin(E + ph), E) * s


def _jnp_pe_mm(P, ph, trg, s, x):
    return _jnp_pe_out(jnp.dot(x, P, preferred_element_type=jnp.float32),
                       ph, trg, s)


def _jnp_pe_vpu(P, ph, trg, s, x):
    E = jnp.zeros(x.shape, jnp.float32)
    for cc in range(3):
        E = E + jnp.broadcast_to(x[:, cc:cc + 1], x.shape) * P[cc, :]
    return _jnp_pe_out(E, ph, trg, s)


def _jnp_sin(x):
    return jnp.sin(x)


def _jnp_pe_mm_bf16(P, ph, trg, s, x):
    E = jnp.dot(x.astype(jnp.bfloat16), P.astype(jnp.bfloat16),
                preferred_element_type=jnp.float32)
    return _jnp_pe_out(E, ph, trg, s)


RESTATED = {"pe_mm": _jnp_pe_mm, "pe_vpu": _jnp_pe_vpu, "sin": _jnp_sin,
            "pe_mm_bf16": _jnp_pe_mm_bf16}


@pytest.mark.parametrize("probe", sorted(RESTATED))
def test_pe_probe_matches_restated_kernel_body(probe):
    x = anatomy.chain_operands(N, 0)["x128"]
    ops = ([] if probe == "sin" else anatomy.pe_mm_rows()) + [x]
    got = anatomy.PROBES[probe](*ops).numpy()
    with jax.disable_jit():
        ref = np.asarray(RESTATED[probe](*[jnp.asarray(t.numpy())
                                           for t in ops]))
    assert got.shape == (N, 128) and np.isfinite(got).all()
    arg = x.numpy() if probe == "sin" \
        else x.numpy()[:, :3] @ ops[0].numpy()[:3] + ops[1].numpy()
    assert (np.abs(got - ref) <= F32_ATOL + 2.0 ** -23 * np.abs(arg)).all()
    if probe != "sin":
        # the encoding really encodes: trig columns differ from the input
        assert np.abs(got[:, 3:63]).max() <= 1.0 and np.abs(got).max() > 1.0


def test_pe_mm_rows_are_what_the_stale_line_meant():
    P, ph, trg, s = (t.numpy() for t in anatomy.pe_mm_rows())
    assert P.shape == (128, 128) and not P[3:].any()
    assert ((P != 0).sum(0) <= 1).all()                 # one entry a column
    nz = P[P != 0]
    assert (np.log2(nz) == np.round(np.log2(nz))).all()     # powers of two
    assert set(np.unique(ph)) == {np.float32(0), np.float32(np.pi / 2)}
    assert trg.sum() == 60 and (s == 1).all()


def test_plain_pe_mm_equals_pe_vpu_exactly():
    ops = anatomy.pe_mm_rows() + [anatomy.chain_operands(256, 3)["x128"]]
    assert torch.equal(anatomy.PROBES["pe_mm"](*ops),
                       anatomy.PROBES["pe_vpu"](*ops))


def test_plain_static_equals_consol_bitwise_and_concat_split_agree():
    o = anatomy.net_operands(512, 1)
    a = anatomy.PROBES["static"](*anatomy.net_inputs(o, "static"))
    b = anatomy.PROBES["consol"](*anatomy.net_inputs(o, "consol"))
    assert torch.equal(a, b)
    c = anatomy.chain_operands(512, 1)
    ins = anatomy.chain_inputs(c, True)
    _assert_bf16_close(anatomy.PROBES["concat"](*ins).numpy(),
                       anatomy.PROBES["split"](*ins).numpy())
    # the skip is live: without it the chain gives something else
    plain = anatomy.PROBES["chain8"](*anatomy.chain_inputs(c, False))
    assert not torch.equal(plain, anatomy.PROBES["split"](*ins))


ENTRY_NAMES = {
    ka: ["chain8_arbitrary", "chain8_parallel", "chain8_concat_skip",
         "chain8_split_skip", "pe_matmul_f32", "pe_vpu_bcast", "sin_only",
         "pe_matmul_bf16"],
    ka2: ["staticnet", "fullnet_nope", "pe_only_vpu", "staticnet_consol"]}


@pytest.mark.parametrize("mod", [ka, ka2], ids=["anatomy", "anatomy2"])
def test_entry_point_on_cpu(mod, tmp_path, monkeypatch, capsys):
    before = [open(p, "rb").read() for p in RECORDS]
    out = tmp_path / "r.json"
    res = mod.main(device="cpu", n=128, reps=1, out=str(out))
    assert list(res["ms"]) == ENTRY_NAMES[mod]
    assert all(np.isfinite(v) and v > 0 for v in res["ms"].values())
    assert res["device"].startswith("cpu") and res["n"] == 128
    printed = capsys.readouterr().out
    for name in ENTRY_NAMES[mod]:
        assert f"{name}: " in printed
    assert json.loads(out.read_text()) == res
    # never into the JAX package's records directory
    with pytest.raises(ValueError, match="records"):
        mod.main(device="cpu", n=128, reps=1,
                 out=os.path.join(ROOT, "experiments", "x.json"))
    assert not os.path.exists(os.path.join(ROOT, "experiments", "x.json"))
    assert [open(p, "rb").read() for p in RECORDS] == before
    # without a card and without device="cpu": raise, do not carry on
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(n=128, reps=1)


def test_wrappers_on_cpu_do_not_launch_and_refuse_bad_operands():
    P = anatomy.PROBES
    assert len(P) == 11
    o = anatomy.net_operands(64, 0)
    ins = anatomy.net_inputs(o, "static")
    P["static"](*ins)
    P["sin"](o["inp"])
    assert all(p.launches == 0 for p in P.values())
    with pytest.raises(ValueError, match="CUDA tensors"):
        P["static"].cuda(*ins)
    with pytest.raises(ValueError, match="takes 24 operands"):
        P["static"](*ins[:-1])
    with pytest.raises(ValueError, match="operand 23"):
        P["static"](*ins[:-2], o["pe"], o["dt"].float())       # dtype
    with pytest.raises(ValueError, match="operand 22"):
        P["static"](*ins[:-2], o["pe"][:32], o["dt"])          # rows
    with pytest.raises(ValueError, match="operand 0"):
        P["static"](ins[0].t().contiguous().t(), *ins[1:])     # strides
    with pytest.raises(ValueError, match="operand 0"):
        P["sin"](o["inp"][:, :64])                             # columns
    c = anatomy.net_inputs(o, "consol")
    with pytest.raises(ValueError, match="operand 1"):
        P["consol"](c[0], o["wfs"], *c[2:])                    # not stacked
