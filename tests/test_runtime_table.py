"""The device peak table, the compile-cache placement, and the GPU-only
entry points refusing to run without a GPU."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from essentials_tpu import runtime
from essentials_tpu.errors import EssentialsError

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    args = code_or_args if isinstance(code_or_args, list) else \
        [sys.executable, "-c", code_or_args]
    return subprocess.run(args, capture_output=True, text=True, env=env,
                          cwd=cwd, timeout=300)


def test_h100_kind_maps_to_its_row():
    dev = SimpleNamespace(device_kind="NVIDIA H100 80GB HBM3",
                          platform="gpu")
    p = runtime.device_properties(dev)
    assert (p.platform, p.hbm_gbps, p.mem_gib, p.l2_mib, p.sm_count) == \
        ("gpu", 3350.0, 80.0, 50.0, 132)


def test_unknown_device_kind_raises():
    dev = SimpleNamespace(device_kind="Some Accelerator 9000",
                          platform="gpu")
    with pytest.raises(EssentialsError, match="Some Accelerator 9000"):
        runtime.device_properties(dev)


def test_cpu_row_has_no_roofline_share(sample_graph):
    from essentials_tpu.utils.stats import collect_stats
    st = collect_stats("bfs", "sample", sample_graph, 1.0, 2)
    assert st.hbm_gbps is None and st.pct_hbm_roofline is None
    assert st.backend == "cpu" and st.device_kind == "cpu"
    assert st.mteps > 0


_CACHE_PROBE = ("import jax, essentials_tpu; "
                "print(jax.config.jax_compilation_cache_dir)")


def test_compile_cache_env_var_is_honoured(tmp_path):
    out = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(tmp_path)


def test_compile_cache_default_is_inside_the_checkout():
    out = _run(_CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == os.path.join(ROOT, ".jax_cache")


def test_chip_smoke_refuses_without_gpu():
    out = _run([sys.executable, os.path.join(ROOT, "chip_smoke.py")])
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "need a GPU" in out.stderr


def test_chip_smoke_alone_refuses(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_package_imports_no_pallas():
    """No module of the package imports Pallas (no kernel can run in
    interpret mode behind the user's back)."""
    code = (
        "import pkgutil, importlib, sys, essentials_tpu\n"
        "for m in pkgutil.walk_packages(essentials_tpu.__path__, "
        "'essentials_tpu.'):\n"
        "    if not m.name.rsplit('.', 1)[-1].startswith('lib'):\n"
        "        importlib.import_module(m.name)\n"
        "print(sorted(k for k in sys.modules if 'pallas' in k))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
