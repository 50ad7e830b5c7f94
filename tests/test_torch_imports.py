"""The port imports nothing of JAX, of the JAX package or of cv2, and builds
no kernel at import time."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "global_lvba_tpu_torch"
BANNED = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|cv2|global_lvba_tpu(?!_torch))\b",
    re.M)
BLOCKED = ('jax', 'jaxlib', 'cv2', 'global_lvba_tpu')


def _port_modules():
    names = ["global_lvba_tpu_torch"]
    for m in pkgutil.walk_packages([str(PKG)], prefix="global_lvba_tpu_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import importlib\n"
        f"for m in {_port_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "from global_lvba_tpu_torch.kernels import build\n"
        "assert not build._libs\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py"])
def test_source_has_no_jax_import(path):
    assert not BANNED.search((ROOT / path).read_text()), path


def test_parallel_modules_walked_and_distributed_builds_no_kernel():
    """The multi-device modules are among those walked above, and importing
    torch.distributed with them (and making a CPU mesh) builds no kernel."""
    names = _port_modules()
    for m in ("parallel", "parallel.mesh", "parallel.shard",
              "parallel.spatial", "parallel.dryrun"):
        assert f"global_lvba_tpu_torch.{m}" in names
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch.distributed\n"
        "from global_lvba_tpu_torch.parallel import make_mesh, psum\n"
        "import global_lvba_tpu_torch.parallel.dryrun\n"
        "import global_lvba_tpu_torch.parallel.spatial\n"
        "m = make_mesh(2, devices=['cpu'] * 2)\n"
        "assert m.world == 1\n"
        "from global_lvba_tpu_torch.kernels import build\n"
        "assert not build._libs\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_native_modules_walked_and_build_nothing_at_import():
    """The native host runtime and the z-buffer's wrapper are among the
    modules walked above; importing them (and the pipeline modules that
    route through them) builds neither the host library nor a kernel."""
    names = _port_modules()
    for m in ("native", "native.runtime", "kernels.zbuffer"):
        assert f"global_lvba_tpu_torch.{m}" in names
    assert (PKG / "native" / "lvba_native.cpp").exists()
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import global_lvba_tpu_torch.pipeline.system\n"
        "import global_lvba_tpu_torch.kernels.zbuffer\n"
        "from global_lvba_tpu_torch.native import runtime\n"
        "from global_lvba_tpu_torch.kernels import build\n"
        "assert runtime._lib is None and not build._libs\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_image_modules_walked_and_build_nothing_at_import():
    """The image modules (decoders and writers, drawing, cv2's filters,
    the undistortion and colorization wrappers) are among the modules
    walked above, and
    importing them with cv2 blocked builds neither the host library nor a
    kernel."""
    names = _port_modules()
    for m in ("io.image", "pipeline.draw", "pipeline.draw_data",
              "utils.imgproc", "kernels.undistort", "kernels.colorize"):
        assert f"global_lvba_tpu_torch.{m}" in names
    for src in ("undistort.cu", "colorize.cu"):
        assert (PKG / "csrc" / src).exists()
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import global_lvba_tpu_torch.io.image\n"
        "import global_lvba_tpu_torch.utils.imgproc\n"
        "import global_lvba_tpu_torch.pipeline.draw\n"
        "import global_lvba_tpu_torch.pipeline.outputs\n"
        "import global_lvba_tpu_torch.pipeline.sift_frontend\n"
        "import global_lvba_tpu_torch.kernels.undistort\n"
        "import global_lvba_tpu_torch.kernels.colorize\n"
        "from global_lvba_tpu_torch.native import runtime\n"
        "from global_lvba_tpu_torch.kernels import build\n"
        "assert runtime._lib is None and not build._libs\n"
        "assert 'undistort' in build.SOURCES and 'colorize' in build.SOURCES\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
