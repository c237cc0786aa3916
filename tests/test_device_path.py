"""Device-path settings that hold on every backend: the compile-cache
location, the forward/backward matmul precision, and both counting regimes
against the spec oracle."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_dir(tmp_path, env_dir):
    """Unset: the package pins a fixed .jax_cache/ at the checkout root.
    Set: JAX_COMPILATION_CACHE_DIR wins and the package sets nothing."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run(
        [sys.executable, "-c",
         "import varigraph_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.strip()
    want = (str(tmp_path / env_dir) if env_dir
            else os.path.join(os.path.realpath(ROOT), ".jax_cache"))
    assert os.path.realpath(out) == os.path.realpath(want)


def _dot_precisions(jaxpr):
    """precision params of every dot_general in a jaxpr, sub-jaxprs too."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    out.extend(_dot_precisions(inner))
    return out


def test_forward_backward_dot_is_highest_precision():
    from varigraph_tpu.genotype.engine_jax import _forward_backward

    W, N, S, P = 2, 8, 16, 2
    args = (
        jnp.zeros((W, N, S), jnp.float32), jnp.ones((W, N), jnp.int32),
        *[jnp.full((W, N), -1.0, jnp.float32)] * 4,
        jnp.zeros((W, S, S), jnp.int32), jnp.zeros((W, S), jnp.float32),
        jnp.ones((W, S), jnp.bool_), jnp.bool_(False),
    )
    jaxpr = jax.make_jaxpr(functools.partial(_forward_backward, P=P))(*args)
    precs = _dot_precisions(jaxpr.jaxpr)
    assert precs, "forward/backward has no dot_general"
    highest = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None and all(x == highest for x in p), precs


@pytest.mark.parametrize("regime", ["_count_fused", "_count_packed_super"])
def test_counting_regimes_match_sketch_ref(regime):
    """Both counting dispatches give the spec oracle's exact per-key counts
    (sketch_ref + bincount) on sub-batches of varied read lengths."""
    import chip_smoke as cs
    from varigraph_tpu.genotype import counting as C

    codes, kmers, keys = cs.counting_fixture(96, 64, 60, 600, seed=3)
    fn = getattr(C, regime)
    n_sub = C._FUSE if regime == "_count_fused" else 8
    stack, want = cs.counting_stack(codes, kmers, keys, n_sub, 64, seed=9)
    got = np.asarray(fn(jnp.zeros((len(keys),), jnp.uint32),
                        jnp.asarray(keys), jnp.asarray(stack), cs.K))
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_join_budget_cpu_setting():
    """The CPU backend reports no memory limit, so the join plans for the
    named CPU budget; a device limit scales by _JOIN_MEM_FRACTION."""
    from varigraph_tpu.genotype import counting as C

    assert jax.local_devices()[0].memory_stats() is None
    assert C._join_budget() == C._JOIN_BUDGET_CPU
    # an 87M-key table at the production batch stays at the group cap
    assert C._pick_super_rows(87_000_000, 16384 * 134) == C._SUPER_ROWS_MAX
