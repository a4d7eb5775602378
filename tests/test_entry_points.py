"""Entry points and process set-up: the persistent compile cache's
directory, the GPU guard of the measurement scripts, and a main path
that runs without PyYAML. Each case runs in a fresh interpreter, because
what it checks is fixed when JAX or the package is first imported."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _run(code, env_extra=None, unset=(), timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in unset}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=timeout,
    )


_CACHE_PROBE = """
    import json, os
    import jax, jax.numpy as jnp
    from flobaroid_tpu.utils.cli import setup_jax
    used = setup_jax()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.jit(lambda x: jnp.sin(x) * 3.0)(jnp.arange(7.0)).block_until_ready()
    print(json.dumps(dict(used=used, config=jax.config.jax_compilation_cache_dir,
                          files=sorted(os.listdir(used)))))
"""


@pytest.mark.timeout(120)
@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compile_cache_directory(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and nothing
    else is set in code; otherwise the cache is the fixed in-checkout
    `.jax_cache/`, which git ignores."""
    if env_set:
        want = str(tmp_path / "cache")
        r = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": want})
    else:
        want = os.path.join(REPO, ".jax_cache")
        r = _run(_CACHE_PROBE, unset=("JAX_COMPILATION_CACHE_DIR",))
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["used"] == want and out["config"] == want
    assert out["files"], "no compiled program was written to the cache"


@pytest.mark.timeout(120)
@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_measurement_scripts_refuse_cpu(script):
    """The measurement entry points never fall back to the CPU: without
    a GPU they exit non-zero, say why, and print no result."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, script)], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout and '"metric"' not in r.stdout


@pytest.mark.timeout(120)
def test_main_path_runs_without_yaml():
    """PyYAML is needed only to read config files: the package imports,
    and a 7-DOF streamed identification runs, with `yaml` unimportable."""
    r = _run("""
        import os, shutil, sys, tempfile
        sys.modules["yaml"] = None  # any `import yaml` now raises
        import numpy as np
        from flobaroid_tpu.identification.identifier import Identification
        from flobaroid_tpu.utils.config import load_config
        import bench

        urdf = shutil.copy(os.path.join(
            "examples", "models", "sevenlink_arm.urdf"), tempfile.mkdtemp())
        opt = load_config(None, overrides=dict(
            bench.SEVENLINK_OVERRIDES, constrainToConsistent=0,
            randomSamples=500))
        idf = Identification(opt, urdf)
        idf.data.init_from_data(bench.build_samples(urdf, n=400))
        idf.estimateParameters()
        assert np.all(np.isfinite(idf.model.xBase))
        try:
            load_config("examples/configs/sevenlink_arm.yaml")
        except ImportError:
            print("config files need yaml")
        print("ran without yaml", float(idf.res_error))
    """)
    assert r.returncode == 0, r.stderr
    assert "config files need yaml" in r.stdout
    assert "ran without yaml" in r.stdout
