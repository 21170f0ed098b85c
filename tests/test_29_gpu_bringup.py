"""GPU bring-up pieces that the CPU can check.

* the one helper deciding how Pallas kernels are built (interpret on the
  CPU, Triton on the GPU, anything else refused);
* compile-cache placement (``JAX_COMPILATION_CACHE_DIR`` or the fixed
  ``<repo>/.jax_cache``);
* the s-step Triton kernel (interpret mode) against the plain jnp pass over
  several geometries, tile configs and dtypes;
* the phases of ``chip_smoke.py`` at tiny sizes, and its refusal to run
  without a GPU;
* the compiled kernel on a real GPU (``gpu`` marker; skips elsewhere).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from legionsolvers_tpu.ops import grid2d
from legionsolvers_tpu.ops.pallas import interpret_mode, sstep2d

FIVE = (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
        (4.0, -1.0, -1.0, -1.0, -1.0))
NINE = (tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)),
        tuple(8.0 if (dy, dx) == (0, 0) else -1.0
              for dy in (-1, 0, 1) for dx in (-1, 0, 1)))
# nonsymmetric, no centre-row neighbours on one side
SKEW = (((0, 0), (-1, 1), (1, 0), (0, -1)), (3.0, -0.5, -1.25, -0.75))


# ------------------------------------------------------------- build mode

@pytest.mark.parametrize("platform,expected", [("cpu", True), ("gpu", False)])
def test_interpret_mode_by_platform(platform, expected):
    assert interpret_mode(platform) is expected


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_interpret_mode_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match="no Pallas kernel build"):
        interpret_mode(platform)


def test_interpret_mode_default_backend():
    assert interpret_mode() is (jax.default_backend() == "cpu")


# ------------------------------------------------------------ compile cache

def test_compile_cache_env_set(monkeypatch, tmp_path):
    from legionsolvers_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch):
    from legionsolvers_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# ------------------------------------------------- Triton pass vs jnp pass

def _state(shape, dtype, seed):
    keys = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(jax.random.normal(k, shape, dtype) for k in keys)


GEOMETRIES = [
    # (rows, cols, stencil, kernel config TC,RB,warps,stages)
    (32, 128, FIVE, (128, 16, 4, 2)),
    (37, 200, FIVE, (64, 8, 4, 2)),     # ragged rows and columns
    (20, 96, NINE, (32, 16, 4, 2)),
    (24, 40, SKEW, (16, 8, 2, 2)),      # nonsymmetric
    (5, 70, FIVE, (128, 128, 4, 2)),    # fewer rows than one program
]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("R,C,stencil,config", GEOMETRIES)
def test_triton_step2_matches_jnp(R, C, stencil, config, dtype):
    offs, vals = stencil
    x, r, p = _state((R, C), dtype, seed=R * C)
    kw = dict(offsets=offs, values=vals)
    g_ref = grid2d.gram2_jnp(r, p, **kw)
    g = sstep2d.gram2(r, p, config=config, **kw)
    coef, _, _ = grid2d.cg2_coeffs(g_ref)
    ref = grid2d.step2_jnp(x, r, p, coef, **kw)
    got = sstep2d.step2(x, r, p, coef, config=config, **kw)
    tol = 1e-5 if dtype == jnp.float32 else 1e-12
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == dtype and a.shape == (R, C)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=tol * float(jnp.max(jnp.abs(b))))
    gtol = 1e-4 if dtype == jnp.float32 else 1e-10
    for gk, gr in ((g, g_ref), (got[3], ref[3])):
        np.testing.assert_allclose(np.asarray(gk), np.asarray(gr), rtol=gtol,
                                   atol=gtol * float(jnp.max(jnp.abs(gr))))


def test_triton_kernel_rejects_wide_stencils():
    offs = ((0, 0), (0, 2), (0, -2))
    assert not sstep2d.supported(offs)
    assert not sstep2d.supported(((2, 0), (0, 0)))
    assert sstep2d.supported(FIVE[0]) and sstep2d.supported(NINE[0])
    x = jnp.ones((16, 16), jnp.float32)
    with pytest.raises(ValueError, match="s-step kernel"):
        sstep2d.gram2(x, x, offsets=offs, values=(1.0, 1.0, 1.0))


def test_jnp_step2_is_two_cg_iterations():
    """The jnp reference pass == two textbook CG iterations (fp64)."""
    offs, vals = FIVE
    x, r, p = _state((24, 40), jnp.float64, seed=3)
    kw = dict(offsets=offs, values=vals)
    coef, rr1, rr2 = grid2d.cg2_coeffs(grid2d.gram2_jnp(r, p, **kw))
    xo, ro, po, gn = grid2d.step2_jnp(x, r, p, coef, **kw)
    A = lambda v: grid2d.apply2d(v, offs, vals)
    for _ in range(2):
        Ap = A(p)
        rr = jnp.sum(r * r)
        a = rr / jnp.sum(p * Ap)
        x, r = x + a * p, r - a * Ap
        p = r + (jnp.sum(r * r) / rr) * p
    for got, exp in ((xo, x), (ro, r), (po, p)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                                   rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(rr2), float(jnp.sum(r * r)), rtol=1e-10)
    np.testing.assert_allclose(float(gn[0]), float(jnp.sum(r * r)), rtol=1e-10)


@pytest.mark.gpu
def test_triton_kernel_compiled_on_gpu(gpu_device):
    """The compiled kernel (not the interpreter) matches the jnp pass."""
    offs, vals = FIVE
    x, r, p = _state((512, 384), jnp.float32, seed=0)
    kw = dict(offsets=offs, values=vals)
    coef, _, _ = grid2d.cg2_coeffs(grid2d.gram2_jnp(r, p, **kw))
    ref = grid2d.step2_jnp(x, r, p, coef, **kw)
    got = sstep2d.step2(x, r, p, coef, **kw)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(ref[3]),
                               rtol=1e-4)


# --------------------------------------------------------- chip_smoke.py

def test_chip_smoke_refuses_without_gpu(capsys):
    import chip_smoke

    if jax.devices()[0].platform == "gpu":
        pytest.skip("a GPU is present")
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert "no GPU found" in out.err
    assert '"ok"' not in out.out


@pytest.fixture(scope="module")
def smoke_ref():
    import chip_smoke

    return chip_smoke.phase_b(n=48, iters=8)[0]


@pytest.mark.parametrize("phase", ["a", "b", "c", "d", "e", "f", "g"])
def test_chip_smoke_phase_tiny(phase, smoke_ref):
    import chip_smoke as cs

    run = {
        "a": lambda: cs.phase_a(),
        "b": lambda: cs.phase_b(n=48, iters=8),
        "c": lambda: cs.phase_c(n=48, bicg_it=6, cycles=2, pcg_it=8),
        "d": lambda: cs.phase_d(n3=12, n1=2048, iters=8),
        "e": lambda: cs.phase_e(n_dia=40, n_scr=48, n_rand=65536, iters=8),
        "f": lambda: cs.phase_f(smoke_ref, n=48, iters=8),
        "g": lambda: cs.phase_g(n=40),
    }[phase]
    run()


def test_chip_smoke_check_raises_above_tolerance():
    import chip_smoke

    chip_smoke.check("t", "ok", 1e-3, 1e-2, "reason")
    with pytest.raises(AssertionError):
        chip_smoke.check("t", "bad", 2e-2, 1e-2, "reason")
    with pytest.raises(AssertionError):
        chip_smoke.rel_dev([np.nan], [1.0])
