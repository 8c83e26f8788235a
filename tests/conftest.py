"""Test harness: virtual 8-device CPU mesh (SURVEY.md §4 TPU translation —
single-host multi-chip tests, v5e-8-like 8 ranks)."""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import tempfile  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache (ISSUE 11): the suite compiles many
# near-identical mixed/train steps — every ServingEngine/trainer builds
# a FRESH jit closure, so the in-process jit cache never dedups them,
# but the executables hash to the same HLO. Caching compiled binaries
# on disk (keyed by HLO hash — semantics-free by construction) lets
# later duplicates load instead of recompile, both within one tier-1
# run and across runs, keeping the suite inside its wall-clock budget.
# Compile-COUNT contracts are unaffected: instrumented_jit counts
# trace-level cache misses, and a disk hit is still one of those.
jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get("PADDLE_TPU_TEST_JAX_CACHE",
                   os.path.join(tempfile.gettempdir(),
                                "paddle_tpu_jax_cache")))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.4)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy compile/e2e tests excluded from tier-1")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture(autouse=True)
def _seed():
    import paddle_tpu as paddle
    paddle.seed(1234)
    yield


# Trace-discipline guards (ISSUE 12, docs/ANALYSIS.md): every test
# runs under analysis.guards.sanitize — jax's device-to-host transfer
# guard (a no-op on this CPU backend by construction, a real implicit-
# sync tripwire on device backends) plus the compile-count watchdog:
# any one-compile-contract jit instance (serving_mixed_step, ...)
# that compiles a second time FAILS the test right here, instead of
# surfacing as a review finding two PRs later. PADDLE_TPU_GUARDS=0
# opts out; =nan additionally flips jax_debug_nans.
@pytest.fixture(autouse=True)
def _guards():
    from paddle_tpu.analysis import guards
    kw = guards.from_env()
    if kw is None:
        yield None
        return
    with guards.sanitize(**kw) as wd:
        yield wd
    if wd is not None and wd.violations:
        pytest.fail("compile watchdog: "
                    + "; ".join(str(v) for v in wd.violations))


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_makereport(item, call):
    # a test-body exception never unwinds through the _guards yield
    # fixture (pytest catches it in the call phase), so transfer-guard
    # trips are counted HERE, off the test report's excinfo
    outcome = yield
    if call.when == "call" and call.excinfo is not None:
        from paddle_tpu.analysis import guards
        if guards.from_env() is not None:     # PADDLE_TPU_GUARDS=0
            guards.note_exception(call.excinfo.value)
    return outcome
