"""The kernel implementation-variant axis (pallas / xla / ref) in the port,
held to the reference's ``tests/test_kernel_impls.py`` on the CPU.

* Every ``<name>_op`` wrapper of the port agrees with the reference's of
  the same variant on the same numpy inputs: the reference's ``pallas``
  runs in interpret mode (its own default off a TPU), the port's runs the
  hand-kernel wrapper, which computes the plain version on CPU tensors.
  Tolerances are the port's stated ones (``tests/test_torch_serve_cli.py``
  and ``tests/test_torch_lm_kernels.py``): taylor and gaussian rtol 1e-5
  atol 1e-6, matmul rtol 1e-5 atol 1e-6*K, mandelbrot exact, ray atol
  1e-4, rap rtol 1e-5 atol 1e-6*L, f32 flash 2e-5, linear attention 3e-4.
* Within the port, ``pallas`` matches ``ref`` under the reference's
  per-kernel tolerances, and ``xla`` equals ``ref`` bit for bit (one
  plain function under two names), takes the same keywords and keeps no
  reference to what it was given.
* The default is backend-aware: ``pallas`` where a CUDA card is, ``xla``
  elsewhere.
* ``build_kernel(name, impl=...)`` round-trips through the registry as
  the reference's does: memoized per canonical impl, "auto" aliased to
  the default, unknown impls refused, kernels without an ``impl`` field
  (plugins, and ``temporary_plugins`` overrides of a builtin) refuse a
  variant loudly.
* Each variant co-executes on two CPU units under every policy on both
  data planes within tolerance of ``ref``, USM and BUFFERS bitwise equal
  within a variant; the serve path records the resolved variant, and the
  DES path accepts the field without changing its model.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from numpy.testing import assert_allclose

import repro.kernels as ref_kernels
import repro.launch.serve as ref_serve
from repro_torch.api import (CoexecSpec, build_kernel, kernel_demo_inputs,
                             register_kernel, scheduler_names,
                             temporary_plugins)
from repro_torch.core import (ArgSpec, CoexecEngine, CoexecKernel,
                              OutputSpec, counits_from_devices)
from repro_torch.kernels import (KERNEL_IMPLS, default_impl, demo_spheres,
                                 flash_attention_op, flash_attention_plain,
                                 gaussian_op, linear_attention_op,
                                 linear_attention_plain, mandelbrot_op,
                                 matmul_op, rap_op, raytrace_op, ref,
                                 resolve_impl, taylor_op, taylor_sin_plain)
from repro_torch.launch import serve

PAPER_KERNELS = ("gaussian", "mandelbrot", "matmul", "rap", "ray", "taylor")
OPS = ("flash_attention", "gaussian", "linear_attention", "mandelbrot",
       "matmul", "rap", "raytrace", "taylor")
N = 220          # engine tests: not a power of two (uneven packages)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shared_units():
    """One pair of CPU units for the whole module."""
    return counits_from_devices(["cpu", "cpu"], speed_hints=(0.4, 0.6))


def base_spec(memory: str = "usm", policy: str = "hguided") -> CoexecSpec:
    return (CoexecSpec.builder()
            .policy(policy)
            .units(count=2, kinds=("cpu", "cpu"), speed_hints=(0.4, 0.6))
            .dist(0.4)
            .memory(memory)
            .build())


def run_engine(memory, kernel, inputs, units, policy="hguided"):
    spec = base_spec(memory, policy)
    with CoexecEngine.from_spec(spec, units=units) as engine:
        sched = spec.build_scheduler(N, len(units))
        h = engine.submit(sched, kernel, inputs, kernel.alloc_out(N, inputs))
        out = h.result(timeout=120)
    return out.copy(), h.stats


# ---------------------------------------------------------------------------
# Wrapper parity: the port's variants, and the port against the reference
# ---------------------------------------------------------------------------

def _cases(seed: int = 7) -> dict:
    """name -> (port op, reference op, numpy args, kwargs for every
    variant, the reference Pallas body's block sizes, (rtol, atol) of
    port against reference, (rtol, atol) of pallas against ref within
    the port): the reference's random shapes, drawn from numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    m, k, n = rng.integers(17, 90, size=3)
    a = rng.normal(size=(m, k)).astype(f32)
    b = rng.normal(size=(k, n)).astype(f32)
    h, w = rng.integers(20, 150, size=2)
    img = rng.normal(size=(h, w)).astype(f32)
    x = rng.uniform(-3, 3, size=(int(rng.integers(100, 3000)),)).astype(f32)
    side = int(rng.integers(16, 40))
    cre, cim = np.meshgrid(np.linspace(-2.2, 0.8, side, dtype=f32),
                           np.linspace(-1.4, 1.4, side, dtype=f32))
    rn = int(rng.integers(200, 900))
    dx, dy = rng.uniform(-.4, .4, (2, rn)).astype(f32)
    dz = np.sqrt(np.maximum(1 - dx**2 - dy**2, .5)).astype(f32)
    rap_n, rap_l = int(rng.integers(50, 300)), int(rng.integers(16, 70))
    vals = rng.normal(size=(rap_n, rap_l)).astype(f32)
    lens = rng.integers(0, rap_l + 1, size=(rap_n,)).astype(np.int32)
    q = rng.normal(size=(1, 2, 64, 16)).astype(f32)
    kk = rng.normal(size=(1, 1, 64, 16)).astype(f32)
    v = rng.normal(size=(1, 1, 64, 16)).astype(f32)
    q2 = rng.normal(size=(2, 96, 8)).astype(f32)
    k2 = (rng.normal(size=(2, 96, 8)) * .2).astype(f32)
    v2 = rng.normal(size=(2, 96, 12)).astype(f32)
    ld = -np.abs(rng.normal(size=(2, 96)) * .1).astype(f32)
    return {
        "matmul": (matmul_op, ref_kernels.matmul_op, (a, b), {},
                   dict(bm=64, bn=64, bk=64), (1e-5, 1e-6 * k),
                   (2e-5, 2e-5)),
        "gaussian": (gaussian_op, ref_kernels.gaussian_op, (img,), {},
                     dict(bm=32), (1e-5, 1e-6), (1e-5, 1e-5)),
        "taylor": (taylor_op, ref_kernels.taylor_op, (x,), dict(terms=12),
                   dict(bm=8), (1e-5, 1e-6), (1e-5, 1e-6)),
        "mandelbrot": (mandelbrot_op, ref_kernels.mandelbrot_op,
                       (cre, cim), dict(max_iter=48), dict(bm=8),
                       (0.0, 0.0), (0.0, 0.0)),
        "raytrace": (raytrace_op, ref_kernels.raytrace_op,
                     (dx, dy, dz, demo_spheres(5)), {}, dict(bm=8),
                     (0.0, 1e-4), (1e-3, 1e-4)),
        "rap": (rap_op, ref_kernels.rap_op, (vals, lens), {}, dict(bm=32),
                (1e-5, 1e-6 * rap_l), (1e-5, 1e-5)),
        "flash_attention": (flash_attention_op,
                            ref_kernels.flash_attention_op, (q, kk, v), {},
                            dict(bq=32, bk=32), (2e-5, 2e-5), (2e-5, 2e-5)),
        "linear_attention": (linear_attention_op,
                             ref_kernels.linear_attention_op,
                             (q2, k2, v2, ld), {}, dict(chunk=32),
                             (3e-4, 3e-4), (3e-4, 3e-4)),
    }


def _port(op, args, **kw) -> np.ndarray:
    return op(*(torch.from_numpy(a) for a in args), **kw).numpy()


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("name", OPS)
def test_wrapper_matches_the_reference_variant(name, impl):
    """The port's ``<name>_op(impl=i)`` against the reference's on the
    same numpy inputs, for each of the three variants."""
    op, ref_op, args, kw, blocks, (rtol, atol), _ = _cases()[name]
    got = _port(op, args, impl=impl, **kw)
    ref_kw = dict(kw, **blocks) if impl == "pallas" else kw
    want = np.asarray(ref_op(*(jnp.asarray(a) for a in args), impl=impl,
                             **ref_kw))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=impl)


@pytest.mark.parametrize("name", OPS)
def test_wrapper_pallas_matches_ref(name):
    op, _, args, kw, _, _, (rtol, atol) = _cases(11)[name]
    got = _port(op, args, impl="pallas", **kw)
    want = _port(op, args, impl="ref", **kw)
    assert got.dtype == want.dtype
    assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", OPS)
def test_wrapper_xla_matches_ref_bitwise(name):
    """One plain function through its cached partial and eagerly."""
    op, _, args, kw, _, _, _ = _cases(13)[name]
    np.testing.assert_array_equal(_port(op, args, impl="xla", **kw),
                                  _port(op, args, impl="ref", **kw))


@pytest.mark.parametrize("impl", ("xla", "ref"))
def test_wrapper_plain_variants_keep_no_buffer(impl):
    """``out=`` goes to the plain version as given, and neither plain
    variant holds on to the buffer (or anything else) after the call."""
    import gc
    import weakref

    x = torch.from_numpy(
        np.random.default_rng(17).uniform(-2, 2, 256).astype(np.float32))
    want = taylor_op(x, impl="ref")
    refs = []
    for _ in range(2):
        buf = torch.empty_like(x)
        assert taylor_op(x, impl=impl, out=buf) is buf
        assert torch.equal(buf, want)
        refs.append(weakref.ref(buf))
        del buf
    gc.collect()
    assert all(r() is None for r in refs)


def test_wrapper_default_is_backend_aware(monkeypatch):
    """The default impl is the hand kernel only where a CUDA card is."""
    assert resolve_impl(None) == default_impl()
    assert resolve_impl("") == resolve_impl("auto") == default_impl()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_impl() == "xla"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_impl() == "pallas"
    with pytest.raises(ValueError, match="impl"):
        resolve_impl("opencl")


def test_wrapper_default_matches_explicit_default_impl():
    x = torch.from_numpy(
        np.random.default_rng(7).uniform(-2, 2, 512).astype(np.float32))
    assert torch.equal(taylor_op(x), taylor_op(x, impl=default_impl()))


@pytest.mark.parametrize("op,name", [(flash_attention_op, "flash_attention"),
                                     (linear_attention_op,
                                      "linear_attention")])
def test_pallas_op_refuses_inputs_that_require_grad(op, name):
    """The hand kernels have no backward: their variant refuses a graph,
    as the wrappers do, on the CPU too; ``ref`` differentiates."""
    _, _, args, kw, _, _, _ = _cases()[name]
    ins = [torch.from_numpy(a).requires_grad_() for a in args]
    with pytest.raises(ValueError, match="no backward"):
        op(*ins, impl="pallas", **kw)
    op(*ins, impl="ref", **kw).sum().backward()
    assert all(t.grad is not None for t in ins)


def test_ref_module_binds_the_plain_versions():
    """The reference's oracle names, each the port's plain version; the
    whole-image Gaussian agrees with the reference's at its edges."""
    from repro.kernels import ref as jref

    assert ref.taylor_sin is taylor_sin_plain
    assert ref.attention is flash_attention_plain
    assert ref.linear_attention is linear_attention_plain
    assert_allclose(ref.GAUSS_TAPS, jref.GAUSS_TAPS, rtol=0, atol=0)
    img = np.random.default_rng(3).normal(size=(9, 7)).astype(np.float32)
    assert_allclose(ref.gaussian_blur(torch.from_numpy(img)).numpy(),
                    np.asarray(jref.gaussian_blur(jnp.asarray(img))),
                    rtol=1e-5, atol=1e-6)
    assert sorted(ref.__all__) == sorted(
        n for n in vars(jref) if n in ref.__all__)


# ---------------------------------------------------------------------------
# Registry round-trips for the impl axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", PAPER_KERNELS)
def test_build_kernel_impl_round_trips(name):
    auto = build_kernel(name)
    assert auto is build_kernel(name, impl="auto")
    assert auto is build_kernel(name, impl=default_impl())
    demo = kernel_demo_inputs(name, 16, seed=1)
    for impl in KERNEL_IMPLS:
        k = build_kernel(name, impl=impl)
        assert k is build_kernel(name, impl=impl)       # memoized
        assert k.name == auto.name                      # same protocol id
        # identical declared semantics (defaults are shared callables)
        assert [(s.name, s.role, s.axis, s.halo, s.default)
                for s in k.args] == [(s.name, s.role, s.axis, s.halo,
                                      s.default) for s in auto.args]
        bound = auto.bind(demo)
        assert k.out.dtype == auto.out.dtype
        assert k.out.trailing_shape(bound) == auto.out.trailing_shape(bound)
        assert k.rowwise == auto.rowwise
        for a, b in zip(kernel_demo_inputs(name, 16, seed=1), demo):
            np.testing.assert_array_equal(a, b)
    assert build_kernel(name, impl="pallas") \
        is not build_kernel(name, impl="ref")


def test_build_kernel_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        build_kernel("taylor", impl="cuda")


def test_impl_request_against_variantless_kernel_is_loud():
    """A kernel with no 'impl' field rejects impl= instead of silently
    serving its only body."""
    def factory():
        return CoexecKernel("single",
                            lambda off, x, *, out: torch.mul(x, 2.0,
                                                             out=out),
                            (ArgSpec("x"),), OutputSpec())

    with temporary_plugins():
        register_kernel("single", factory)
        x = torch.ones(4)
        assert build_kernel("single").fn(0, x, out=torch.empty(4))[0] == 2.0
        with pytest.raises(ValueError, match="implementation variants"):
            build_kernel("single", impl="pallas")


def test_temporary_override_not_shadowed_by_factory_cache():
    """An overwrite inside temporary_plugins wins over the lru_cache'd
    builtin factory, and the builtin comes back intact afterwards."""
    builtin = build_kernel("taylor")

    def factory(**kw):
        return CoexecKernel("taylor",
                            lambda off, x, *, out: torch.add(x, 1.0,
                                                             out=out),
                            (ArgSpec("x"),), OutputSpec())

    with temporary_plugins():
        register_kernel("taylor", factory, overwrite=True)
        custom = build_kernel("taylor")
        assert custom is not builtin
        x = torch.zeros(8)
        assert torch.equal(custom.fn(0, x, out=torch.empty(8)), x + 1.0)
        with pytest.raises(ValueError, match="implementation variants"):
            build_kernel("taylor", impl="pallas")
    assert build_kernel("taylor") is builtin            # cache not stale
    assert build_kernel("taylor", impl="pallas") is not builtin


def test_workload_spec_kernel_impl_flows_to_registry():
    wl = (CoexecSpec.builder()
          .workload("taylor", kernel_impl="pallas").build().workload)
    assert wl.kernel_impl == "pallas"
    assert wl.build_kernel() is build_kernel("taylor", impl="pallas")
    # default stays the backend-aware auto
    assert CoexecSpec().workload.build_kernel() is build_kernel("taylor")
    with pytest.raises(ValueError, match="kernel_impl"):
        (CoexecSpec.builder()
         .workload("taylor", kernel_impl="opencl").build())


# ---------------------------------------------------------------------------
# Engine end-to-end: every variant across policies and planes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("name", ("gaussian", "matmul"))
def test_engine_parity_all_policies_both_planes(name, impl, shared_units):
    """The halo (gaussian) and broadcast (matmul) kernels serve each
    variant under every policy on both data planes, held to ``ref``."""
    kernel = build_kernel(name, impl=impl)
    inputs = kernel_demo_inputs(name, N, seed=9)
    want, _ = run_engine("usm", build_kernel(name, impl="ref"), inputs,
                         shared_units, policy="dyn8")
    for policy in scheduler_names():
        for memory in ("usm", "buffers"):
            out, _ = run_engine(memory, kernel, inputs, shared_units,
                                policy=policy)
            assert_allclose(out, want, rtol=2e-5, atol=2e-5,
                            err_msg=f"{name}/{impl}/{policy}/{memory}")


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
@pytest.mark.parametrize("name", PAPER_KERNELS)
def test_usm_buffers_bitwise_parity(name, impl, shared_units):
    """Within a variant, USM and BUFFERS stay bitwise identical, USM
    copies nothing in and BUFFERS copies each package out."""
    kernel = build_kernel(name, impl=impl)
    inputs = kernel_demo_inputs(name, N, seed=7)
    usm_out, usm_stats = run_engine("usm", kernel, inputs, shared_units,
                                    policy="dyn16")
    buf_out, buf_stats = run_engine("buffers", kernel, inputs, shared_units,
                                    policy="dyn16")
    assert np.array_equal(usm_out, buf_out), (
        f"{name}[{impl}]: USM and BUFFERS results differ")
    assert usm_stats.data.h2d_copies == 0
    assert buf_stats.data.d2h_copies == buf_stats.num_packages


@pytest.mark.parametrize("impl", ("auto", *KERNEL_IMPLS))
def test_serve_rows_record_resolved_impl(impl, shared_units):
    """coexec_real_rows reports which variant actually served."""
    spec = serve.default_serve_spec()
    spec = spec.replace(workload=spec.workload.replace(
        name="taylor", kernel_impl=impl, items=256, requests=2,
        concurrent=2))
    rows = serve.coexec_real_rows(spec, policies=("dyn4",),
                                  units=shared_units)
    assert rows and all(r["impl"] == resolve_impl(impl) for r in rows)
    assert all(r["kernel"] == "taylor" for r in rows)


@pytest.mark.parametrize("impl", KERNEL_IMPLS)
def test_sim_backend_accepts_kernel_impl(impl):
    """--kernel-impl flows through the sim path too (the DES costs are
    impl-agnostic): the rows equal the reference's for the same field."""
    spec = serve.default_serve_spec()
    spec = spec.replace(workload=spec.workload.replace(
        name="mandelbrot", kernel_impl=impl)).validate()
    ref_spec = ref_serve.default_serve_spec()
    ref_spec = ref_spec.replace(workload=ref_spec.workload.replace(
        name="mandelbrot", kernel_impl=impl)).validate()
    rows = serve.coexec_sim_rows(spec, policies=("static",))
    assert rows and rows[0]["workload"] == "mandelbrot"
    assert rows == ref_serve.coexec_sim_rows(ref_spec, policies=("static",))
