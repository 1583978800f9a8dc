"""The probe path (mrcaudiocodec_tpu_torch/probes/): each probe body's plain
version against the JAX probe scripts, and (on a card only) each CUDA
probe kernel against its plain version and the SASS audit.

The bodies come from the four TPU probe scripts in `scripts/`. Where a
script's Pallas body still runs here, it runs in interpret mode at the
script's block specs (P1 `_mag_kernel`, P2 `_op_kernel`, P5 `p0`, `p1`,
`p3`). Where it cannot (P5 `p2`/`p4`: interpret mode refuses a negative
`pltpu.roll`; P4: the script no longer imports, its helpers having left
`quant_kernel.py`), a `jax.jit` restatement of the body stands in, with
`jnp.roll` and the helpers' meanings (lookups of `len_small` and
`len_esc`, `unified_layout(fs)["mask2"]`). P3's k1-k3 are `jax.jit` of
the same expressions.

Tolerances, plain against JAX on the CPU: P1, P2, v2, v4, v5, p4 bitwise
(IEEE divide and sqrt are correctly rounded on both sides, the rest is
integer-valued); v3 |diff| <= 1 (a float band sum truncated to int); v1
|diff| <= 4 per entry (XLA's and PyTorch's CPU `pow` differ); p0-p3 atol
1e-2 (XLA orders the row sum otherwise; the sums are about 300 in size).
P3: the port's torch-eager rows equal numpy's "plain" candidate bitwise;
XLA:CPU's own classification is printed, not asserted (it may contract).

Tests marked `cuda` need a card and skip here; the machine with the card
has no JAX, so this module imports JAX only inside the tests that compare
against it, and there the tests run as `MRC_TESTS_KEEP_TPU=1 python -m
pytest tests/test_torch_probes.py -m cuda` (the variable skips conftest's
JAX set-up).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu_torch.probes import (fma_probe, primitive_probe,
                                            quant_bisect, quant_g32)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = (fma_probe, quant_g32, quant_bisect, primitive_probe)
ALL_BODIES = [(m, b) for m in MODULES for b in m.BODIES]
BODY_IDS = [b for _, b in ALL_BODIES]


def _script(name):
    """Import scripts/<name>.py (it imports JAX and the JAX package)."""
    spec = importlib.util.spec_from_file_location(
        f"_probe_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a):
    return np.asarray(a).view(np.uint32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")


@pytest.fixture(scope="module")
def cpu_inputs():
    """{body: CPU argument tuple} at each script's shapes."""
    out = {}
    for m in MODULES:
        out.update(m.body_inputs("cpu"))
    return out


# ---------------------------------------------------------------------------
# P1 and P2 (scripts/tpu_quant_g32.py)
# ---------------------------------------------------------------------------


def test_quant_g32_inputs_match_script():
    script = _script("tpu_quant_g32")
    coeffs, amp, bt = script.make_inputs()
    pc, pa, pb = quant_g32.make_inputs()
    np.testing.assert_array_equal(_bits(pc.numpy()),
                                  _bits(np.asarray(coeffs)))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(amp))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(bt))


def _mag_interpret(script, x, amp_bin, gains):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from mrcaudiocodec_tpu.ops.pallas import quant_kernel
    nf, bf = x.shape[0], quant_kernel.BLOCK_F
    return np.asarray(pl.pallas_call(
        script._mag_kernel,
        out_shape=jax.ShapeDtypeStruct((nf, 1024), jnp.int32),
        grid=(nf // bf,),
        in_specs=[pl.BlockSpec((bf, 1024), lambda i: (i, 0)),
                  pl.BlockSpec((bf, 1024), lambda i: (i, 0)),
                  pl.BlockSpec((bf, 8), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((bf, 1024), lambda i: (i, 0)),
        interpret=True)(jnp.asarray(x), jnp.asarray(amp_bin),
                        jnp.asarray(gains)))


@pytest.mark.parametrize("gain", [0, 128, 248])
def test_mag_probe_plain_matches_pallas_interpret(gain):
    from mrcaudiocodec_tpu_torch.ops import entropy
    script = _script("tpu_quant_g32")
    coeffs, amp, bt = quant_g32.make_inputs(seed=gain, nf=64)
    amp_bin = entropy.amp_to_bins(amp, bt, quant_g32.FS).contiguous()
    gains = torch.full((64, 8), gain, dtype=torch.int32)
    got = quant_g32.mag_probe(coeffs, amp_bin, gains).numpy()
    want = _mag_interpret(script, coeffs.numpy(), amp_bin.numpy(),
                          gains.numpy())
    np.testing.assert_array_equal(got, want)


def test_op_probe_plain_matches_pallas_interpret():
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from mrcaudiocodec_tpu.ops import quantize as jquantize
    script = _script("tpu_quant_g32")
    pairs = quant_g32.sweep_pairs()
    X, S = quant_g32.op_inputs(pairs, "cpu")
    es = np.asarray([e for _, e in pairs], np.int32)
    np.testing.assert_array_equal(
        _bits(S.numpy().ravel()),
        _bits(np.asarray(jquantize.band_steps(jnp.asarray(es)), np.float32)))
    shape = jax.ShapeDtypeStruct(X.shape, jnp.float32)
    nrow = X.shape[0]
    want = pl.pallas_call(
        script._op_kernel, out_shape=(shape, shape, shape), grid=(1,),
        in_specs=[pl.BlockSpec((nrow, 256), lambda i: (0, 0))] * 2,
        out_specs=[pl.BlockSpec((nrow, 256), lambda i: (0, 0))] * 3,
        interpret=True)(jnp.asarray(X.numpy()), jnp.asarray(S.numpy()))
    for g, w in zip(quant_g32.op_probe(X, S), want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(np.asarray(w)))


def test_quant_g32_run_on_cpu():
    res = quant_g32.run("cpu")
    assert set(res["phase1"]) == {n for n, _ in quant_g32.GAIN_SETS}
    assert not any(res["phase1"].values())
    assert set(res["phase2"]) == {0, 8, 128, 248}
    for counts in res["phase3"].values():
        assert counts["plain on cpu"] == 0
        assert counts["plain on the CPU"] == 0


# ---------------------------------------------------------------------------
# P3 (scripts/tpu_fma_probe.py)
# ---------------------------------------------------------------------------


def test_fma64_matches_script():
    script = _script("tpu_fma_probe")
    a, b, c, d = fma_probe.make_inputs()
    np.testing.assert_array_equal(_bits(fma_probe.fma64(a, b, -c)),
                                  _bits(script.fma64(a, b, -c)))
    np.testing.assert_array_equal(_bits(fma_probe.fma64(-c, d, a * b)),
                                  _bits(script.fma64(-c, d, a * b)))


@pytest.mark.parametrize("row", ["a*b-c", "a*b-c*d", "a*b+c*d",
                                 "(a+b)*k1-(c+d)*k2"])
def test_fma_plain_rows_are_plain(row):
    import jax
    import jax.numpy as jnp
    a, b, c, d = fma_probe.make_inputs()
    cands = fma_probe.candidates(a, b, c, d)[row]
    plain = {"a*b-c": fma_probe.k1_plain, "a*b-c*d": fma_probe.k2_plain,
             "a*b+c*d": fma_probe.k3_plain,
             "(a+b)*k1-(c+d)*k2": fma_probe.butterfly_plain}[row]
    t = [torch.from_numpy(v) for v in (a, b, c, d)]
    got = plain(*t).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(cands["plain"]))
    assert "plain" in fma_probe.classify(f"port {row}", got, cands)
    w7, w3 = np.float32(0.7), np.float32(0.3)
    jfn = {"a*b-c": lambda a, b, c, d: a * b - c,
           "a*b-c*d": lambda a, b, c, d: a * b - c * d,
           "a*b+c*d": lambda a, b, c, d: a * b + c * d,
           "(a+b)*k1-(c+d)*k2": lambda a, b, c, d: (a + b) * w7 - (c + d) * w3
           }[row]
    xla = np.asarray(jax.jit(jfn)(*(jnp.asarray(v) for v in (a, b, c, d))))
    print(f"XLA:CPU {row}: {fma_probe.classify(f'XLA:CPU {row}', xla, cands)}")
    if row != "(a+b)*k1-(c+d)*k2":
        name = {"a*b-c": "k1", "a*b-c*d": "k2", "a*b+c*d": "k3"}[row]
        np.testing.assert_array_equal(
            _bits(fma_probe.body(name, *t).numpy()), _bits(cands["plain"]))


def test_fma_run_on_cpu_classifies_plain():
    res = fma_probe.run("cpu")
    assert res["audit"] is None
    for row, matches in res["classes"].items():
        assert "plain" in matches, row


def test_sass_counts_parses_listing():
    text = "\n".join([
        "\t\tFunction : _Zk1",
        "        /*0070*/                   FFMA R5, R2, R3, -R4 ;   /* 0x0 */",
        "        /*0080*/               @!P0 FMUL.FTZ R5, R0, R3 ;   /* 0x0 */",
        "        /*0090*/                   FADD R5, R5, R1 ;   /* 0x0 */",
        "\t\tFunction : _Zk2",
        "        /*0000*/                   FSETP.NEU.FTZ.AND P0, PT, R0, RZ, PT ;",
    ])
    got = fma_probe.sass_counts(text)
    assert got["_Zk1"]["FFMA"] == 1 and got["_Zk1"]["FTZ"] == 1
    assert got["_Zk1"]["instructions"] == 3
    assert got["_Zk2"] == {"FFMA": 0, "FTZ": 1, "instructions": 1,
                           "ftz_ops": {"FSETP.NEU.FTZ.AND": 1}}
    lib = lambda f, z, fn="_Zx_kernel": {"FFMA": f, "FTZ": z, "functions": {
        fn: {"FFMA": f, "FTZ": z, "instructions": 9, "ftz_ops": {}}}}
    audit = {"fft_stages": lib(0, 0), "quant_cost": lib(0, 0),
             "record_pack": lib(0, 0), "rd_loop": lib(0, 0),
             "transients": lib(0, 0), "analysis_pre": lib(0, 0),
             "mdct_post": lib(0, 0), "psycho": lib(0, 0),
             "synth_pre": lib(0, 0), "synth_post": lib(0, 0),
             "pad_rows": lib(0, 0), "probe_fma_contract": lib(3, 0),
             "probe_quant_g32": lib(24, 20, "_Zop_probe_kernel")}
    assert fma_probe.audit_failures(audit) == []
    assert fma_probe.audit_failures({**audit, "quant_cost": lib(1, 0)})
    assert fma_probe.audit_failures({**audit, "record_pack": lib(0, 1)})
    assert fma_probe.audit_failures(
        {k: v for k, v in audit.items() if k != "record_pack"})
    assert fma_probe.audit_failures({**audit, "rd_loop": lib(0, 1)})
    assert fma_probe.audit_failures(
        {k: v for k, v in audit.items() if k != "rd_loop"})
    assert fma_probe.audit_failures({**audit, "psycho": lib(0, 1)})
    assert fma_probe.audit_failures({**audit, "transients": lib(1, 0)})
    assert fma_probe.audit_failures(
        {k: v for k, v in audit.items() if k != "analysis_pre"})
    assert fma_probe.audit_failures({**audit, "synth_post": lib(0, 1)})
    assert fma_probe.audit_failures({**audit, "synth_pre": lib(1, 0)})
    assert fma_probe.audit_failures(
        {k: v for k, v in audit.items() if k != "synth_post"})
    assert fma_probe.audit_failures({**audit, "pad_rows": lib(1, 0)})
    assert fma_probe.audit_failures(
        {k: v for k, v in audit.items() if k != "pad_rows"})
    assert fma_probe.audit_failures({**audit, "probe_fma_contract": lib(0, 0)})
    assert fma_probe.audit_failures(
        {**audit, "probe_primitives": lib(0, 1, "_Zp0_kernel")})


def test_sass_opcodes_parses_listing():
    text = "\n".join([
        "\t\tFunction : _Zk1",
        "        /*0070*/                   FMUL R5, R2, R3 ;   /* 0x0 */",
        "        /*0080*/               @!P0 FMUL.FTZ R5, R0, R3 ;   /* 0x0 */",
        "        /*0090*/                   LOP3.LUT R5, R5, 0x1, RZ, 0xc0, !PT ;",
        "\t\tFunction : _Zk2",
        "        /*0000*/                   BSSY B0, 0x2690 ;",
    ])
    assert fma_probe.sass_opcodes(text) == {"_Zk1": {"FMUL": 2, "LOP3": 1},
                                            "_Zk2": {"BSSY": 1}}


# ---------------------------------------------------------------------------
# P4 (scripts/tpu_quant_bisect.py): jax.jit restatements of v1-v5
# ---------------------------------------------------------------------------


def _jax_bisect(body, x, amp_bin, gains, bt):
    import jax
    import jax.numpy as jnp
    from mrcaudiocodec_tpu import config as JC
    from mrcaudiocodec_tpu import tables as JT
    ca = JT.code_arrays()
    small = jnp.asarray(np.asarray(ca["len_small"], np.float32))
    esc17 = jnp.asarray(np.asarray(ca["len_esc"], np.float32).reshape(17, 17))
    mask2 = jnp.asarray(JT.unified_layout(quant_bisect.FS)["mask2"])
    nf, g = gains.shape

    def mag(x, ab, gains):
        e = jnp.clip(gains[:, :, None] - ab[:, None, :], JC.GAIN_MIN,
                     JC.GAIN_MAX)
        step = jnp.exp2((e.astype(jnp.float32) - JC.GAIN_BIAS) / 4.0)
        return jnp.minimum(jnp.floor((jnp.abs(x)[:, None, :] / step) ** 0.75
                                     + JC.QUANT_MAGIC),
                           float(JC.QMAX)).astype(jnp.int32)

    def v1(x, ab, gains, bt):
        return mag(x, ab, gains).sum(axis=-1)

    def v2(x, ab, gains, bt):
        m = mag(x, ab, gains)
        q = jnp.where(x[:, None, :] < 0, -m, m)
        t4 = (jnp.clip(q, -1, 1) + 1).reshape(nf, g, 256, 4)
        sym = ((t4[..., 0] * 3 + t4[..., 1]) * 3 + t4[..., 2]) * 3 + t4[..., 3]
        return small[sym].sum(axis=-1).astype(jnp.int32)

    def v3(x, ab, gains, bt):
        v = jnp.abs(x).reshape(nf, 512, 2).sum(axis=-1)
        acc = jnp.zeros((nf, mask2.shape[-1]), jnp.float32)
        for t in range(JC.N_BLOCK_TYPES):
            sel = (bt == t).astype(jnp.float32)[:, None]
            acc = acc + sel * jax.lax.dot_general(
                v, mask2[t], dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
        tot = acc.sum(axis=1).astype(jnp.int32)
        return jnp.broadcast_to(tot[:, None], (nf, g))

    def v4(x, ab, gains, bt):
        m = jnp.minimum(jnp.abs(x), 30.0).astype(jnp.int32)
        m2 = jnp.minimum(m, JC.ESC_MAG).reshape(nf, 512, 2)
        tot = esc17[m2[..., 0], m2[..., 1]].sum(axis=1).astype(jnp.int32)
        return jnp.broadcast_to(tot[:, None], (nf, g))

    def v5(x, ab, gains, bt):
        m = jnp.minimum(jnp.abs(x) * 100.0, 4095.0).astype(jnp.int32)
        mp = m.reshape(nf, 512, 2)
        e_esc = jnp.full(mp.shape, 4, jnp.int32)
        for k in range(5, 13):
            e_esc = e_esc + (mp >= (1 << k)).astype(jnp.int32)
        extra = (jnp.where(mp >= JC.ESC_MAG, 2 * e_esc - 3, 0)
                 + (mp > 0).astype(jnp.int32)).sum(axis=-1)
        tot = extra.sum(axis=1).astype(jnp.int32)
        return jnp.broadcast_to(tot[:, None], (nf, g))

    fn = {"v1": v1, "v2": v2, "v3": v3, "v4": v4, "v5": v5}[body]
    return np.asarray(jax.jit(fn)(*(jnp.asarray(v)
                                    for v in (x, amp_bin, gains, bt))))


@pytest.mark.parametrize("body,tol", [("v1", 4), ("v2", 0), ("v3", 1),
                                      ("v4", 0), ("v5", 0)])
def test_bisect_plain_matches_jax(body, tol, cpu_inputs):
    x, amp_bin, gains, bt = quant_bisect.make_inputs("cpu")
    got = quant_bisect.BODIES[body][1](*cpu_inputs[body]).numpy()
    want = _jax_bisect(body, x.numpy(), amp_bin.numpy(), gains.numpy(),
                       bt.numpy())
    assert got.shape == want.shape == (quant_bisect.NF, quant_bisect.G)
    diff = np.abs(got.astype(np.int64) - want)
    print(f"{body}: {int((diff > 0).sum())} entries differ, max {diff.max()}")
    assert diff.max() <= tol


# ---------------------------------------------------------------------------
# P5 (scripts/tpu_primitive_probe.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body", ["p0", "p1", "p3"])
def test_primitive_plain_matches_pallas_interpret(body, cpu_inputs):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    script = _script("tpu_primitive_probe")
    args = cpu_inputs[body]
    bf, nf = script.BLOCK_F, script.NF
    kernel = {"p0": script.p0_reshape, "p1": script.p1_strided,
              "p3": script.p3_deint_mm}[body]
    extra = ([pl.BlockSpec((1024, 512), lambda i: (0, 0))] * 2
             if body == "p3" else [])
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((nf, 8), jnp.float32),
        grid=(nf // bf,),
        in_specs=[pl.BlockSpec((bf, 1024), lambda i: (i, 0))] + extra,
        out_specs=pl.BlockSpec((bf, 8), lambda i: (i, 0)),
        interpret=True)(*(jnp.asarray(a.numpy()) for a in args)))
    got = primitive_probe.BODIES[body][1](*args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-2)


def test_primitive_inputs_match_script():
    rng = np.random.default_rng(0)
    xh = (10.0 * rng.standard_normal((64, 1024))).astype(np.float32)
    np.testing.assert_array_equal(primitive_probe.make_x("cpu").numpy(), xh)


@pytest.mark.parametrize("body,atol", [("p2", 1e-2), ("p4", 0)])
def test_primitive_plain_matches_jax_jit(body, atol, cpu_inputs):
    import jax
    import jax.numpy as jnp

    def p2(x):
        nxt = jnp.roll(x, -1, axis=1)
        iota = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
        pair = jnp.where(iota % 2 == 0, x + nxt, 0.0)
        return jnp.broadcast_to(pair.sum(axis=1, keepdims=True), (x.shape[0], 8))

    def p4(x, tab):
        m = jnp.clip(jnp.abs(x).astype(jnp.int32), 0, 8)
        sym = m * 9 + jnp.roll(m, -1, axis=1)
        iota = jax.lax.broadcasted_iota(jnp.int32, x.shape, 1)
        r = x.shape[0] * 1024
        it = jax.lax.broadcasted_iota(jnp.int32, (r, 81), 1)
        oh = ((sym.reshape(r, 1) == it)
              & (iota % 2 == 0).reshape(r, 1)).astype(jnp.bfloat16)
        bits = jax.lax.dot_general(
            oh, tab.reshape(81, 1).astype(jnp.bfloat16),
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        return jnp.broadcast_to(
            bits.reshape(x.shape[0], 1024).sum(axis=1, keepdims=True),
            (x.shape[0], 8))

    args = cpu_inputs[body]
    want = np.asarray(jax.jit({"p2": p2, "p4": p4}[body])(
        *(jnp.asarray(a.numpy()) for a in args)))
    got = primitive_probe.BODIES[body][1](*args).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# Wrappers: CPU tensors and bad shapes are refused, CPU runs take the plain
# version, the entry points need a card unless --device cpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module,body", ALL_BODIES, ids=BODY_IDS)
def test_probe_kernel_rejects_cpu_and_bad_shapes(module, body, cpu_inputs):
    kernel = module.BODIES[body][0]
    args = cpu_inputs[body]
    with pytest.raises(ValueError, match="needs CUDA"):
        kernel(*args)
    x = args[0]
    bad = (x[..., :x.shape[-1] // 2].contiguous(),) + args[1:]
    with pytest.raises(ValueError, match="want contiguous"):
        kernel(*bad)


@pytest.mark.parametrize("module", MODULES,
                         ids=[m.__name__.rsplit(".", 1)[-1] for m in MODULES])
def test_probe_main_needs_card_unless_cpu(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() would run on it")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        module.main([])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("module,body", ALL_BODIES, ids=BODY_IDS)
def test_probe_kernel_matches_plain_on_card(module, body):
    _need_card()
    kernel, plain = module.BODIES[body]
    args = module.body_inputs("cuda")[body]
    before = module.launches[body]
    got = kernel(*args)
    torch.cuda.synchronize()
    assert module.launches[body] == before + 1
    want = plain(*(a.cpu() for a in args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g = g.cpu()
        if body == "v1":                  # library exp2f/powf: within 4
            assert (g.long() - w.long()).abs().max() <= 4
        elif g.dtype == torch.float32:
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_fma_probe_and_sass_audit_on_card():
    _need_card()
    from mrcaudiocodec_tpu_torch.ops.kernels import build
    build.build()
    res = fma_probe.run("cuda")
    cls = res["classes"]
    for row, matches in cls.items():
        if row.startswith(("torch eager", "port ")):
            assert "plain" in matches, row
    assert "fma" in cls["control k1 a*b-c (--fmad=true)"]
    assert res["audit_failures"] == []
    audit = res["audit"]
    for lib in build.MAIN:
        assert audit[lib]["FFMA"] == 0 and audit[lib]["FTZ"] == 0
    assert audit[fma_probe.CONTROL]["FFMA"] >= 1
