import functools

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: subprocess / multi-device integration tests")
    config.addinivalue_line(
        "markers",
        "pallas_interpret: Pallas kernel parity tests that run in "
        "interpret mode (skipped with a reason where even interpreted "
        "pallas_call cannot execute on this jaxlib)")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the repro_torch CUDA "
        "kernels); skips with a reason where there is none")


@functools.lru_cache(maxsize=1)
def _pallas_interpret_unavailable():
    """Why interpret-mode Pallas can't run here, or None if it can.

    Probed once per session with a trivial kernel. Compiled lowering is
    NOT required (the compat CPU jaxlib can't lower Pallas at all —
    that's what interpret mode is for); only a broken/absent
    jax.experimental.pallas makes the parity suites meaningless.
    """
    try:
        import jax
        import jax.numpy as jnp
        from jax.experimental import pallas as pl

        def k(x_ref, o_ref):
            o_ref[...] = x_ref[...] + 1.0

        out = pl.pallas_call(
            k, out_shape=jax.ShapeDtypeStruct((8,), jnp.float32),
            interpret=True)(jnp.zeros((8,), jnp.float32))
        out.block_until_ready()
    except Exception as e:                      # pragma: no cover
        return f"{type(e).__name__}: {e}"
    return None


def pytest_collection_modifyitems(config, items):
    reason = _pallas_interpret_unavailable()
    if reason is None:
        return
    skip = pytest.mark.skip(
        reason="interpret-mode pallas_call unavailable on this jaxlib: "
               + reason)
    for item in items:                          # pragma: no cover
        if "pallas_interpret" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def pallas_interpret():
    """Force interpret mode for Pallas kernels under test.

    Returns True (the value to pass as ``interpret=``). Tests marked
    ``pallas_interpret`` are skipped wholesale — with the probe's error
    as the reason — on jaxlibs where even interpreted pallas_call
    cannot execute, so tier-1 stays green on the compat stack.
    """
    return True
