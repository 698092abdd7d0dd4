"""The port stands alone: ``stoke_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``stoke_tpu``.

Careful with prefixes: ``"stoke_tpu_torch".startswith("stoke_tpu")`` is
true, so a module is the JAX package's only when its name is
``stoke_tpu`` or starts with ``stoke_tpu.``.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "stoke_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def _forbidden(name: str) -> bool:
    return any(name == top or name.startswith(top + ".")
               for top in ("jax", "jaxlib", "flax", "stoke_tpu"))


def test_forbidden_matches_the_jax_package_only():
    assert _forbidden("stoke_tpu") and _forbidden("stoke_tpu.serving")
    assert _forbidden("jax.numpy") and _forbidden("jax")
    assert not _forbidden("stoke_tpu_torch")
    assert not _forbidden("stoke_tpu_torch.serving.engine")
    assert not _forbidden("jaxtyping")


MODULES = [
    "stoke_tpu_torch.serving.engine",
    "stoke_tpu_torch.convert",
    "stoke_tpu_torch.facade",
    "stoke_tpu_torch.engine",
    "stoke_tpu_torch.data",
    "stoke_tpu_torch.status",
    "stoke_tpu_torch.models.basic",
    "stoke_tpu_torch.models.resnet",
    "stoke_tpu_torch.models.vit",
    "stoke_tpu_torch.ops.chunked_ce",
    "stoke_tpu_torch.io_ops",
    "stoke_tpu_torch.utils",
    "stoke_tpu_torch.utils.printing",
    "stoke_tpu_torch.utils.trees",
    "stoke_tpu_torch.utils.yaml_config",
    "stoke_tpu_torch.utils.tb_writer",
    "stoke_tpu_torch.native",
    "stoke_tpu_torch.models.bert",
    "stoke_tpu_torch.parallel",
    "stoke_tpu_torch.parallel.mesh",
    "stoke_tpu_torch.parallel.sharding",
    "stoke_tpu_torch.parallel.ladder",
    "stoke_tpu_torch.parallel.collectives",
    "stoke_tpu_torch.parallel.zero",
    "stoke_tpu_torch.ops.quant",
    "stoke_tpu_torch.serving.quant",
    "stoke_tpu_torch.utils.prng",
    "stoke_tpu_torch.telemetry",
    "stoke_tpu_torch.telemetry.events",
    "stoke_tpu_torch.telemetry.sinks",
    "stoke_tpu_torch.telemetry.tracing",
    "stoke_tpu_torch.telemetry.recorder",
    "stoke_tpu_torch.telemetry.collectors",
    "stoke_tpu_torch.telemetry.health",
    "stoke_tpu_torch.telemetry.fleet",
    "stoke_tpu_torch.resilience",
    "stoke_tpu_torch.offload",
    "stoke_tpu_torch.supervise",
    "stoke_tpu_torch.remat",
    "stoke_tpu_torch.telemetry.attribution",
    "stoke_tpu_torch.telemetry.memory",
    "stoke_tpu_torch.telemetry.numerics",
    "stoke_tpu_torch.serving.slo",
    "stoke_tpu_torch.serving.roofline",
    "stoke_tpu_torch.telemetry.opsplane",
    "stoke_tpu_torch.ops.attention",
    "stoke_tpu_torch.parallel.tensor",
    "stoke_tpu_torch.models.moe",
    "stoke_tpu_torch.parallel.pipeline",
    "stoke_tpu_torch.models.pipelined_lm",
    "stoke_tpu_torch.analysis",
    "stoke_tpu_torch.analysis.invariants",
    "stoke_tpu_torch.analysis.program",
    "stoke_tpu_torch.compile_cache",
    "stoke_tpu_torch.autotune",
]


@pytest.fixture(scope="module")
def loaded_after():
    """One interpreter imports MODULES in turn and records, after each
    import, every module loaded by then (or the import's error)."""
    code = (
        "import importlib, json, sys, traceback\n"
        "out = {}\n"
        f"for m in {MODULES!r}:\n"
        "    try:\n"
        "        importlib.import_module(m)\n"
        "        out[m] = sorted(sys.modules)\n"
        "    except Exception:\n"
        "        out[m] = traceback.format_exc()\n"
        "print(json.dumps(out))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=240, check=True,
    ).stdout
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_import_loads_no_jax_module(module, loaded_after):
    """Importing ``module`` (after the ones before it in MODULES) loads
    no JAX module: a case fails when its own import pulls one in, and so
    does every case after it."""
    loaded = loaded_after[module]
    assert isinstance(loaded, list), loaded
    assert module in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("how", ["import", "module"])
def test_supervisor_loads_no_torch(how):
    """The restart supervisor outlives a worker that wedged its CUDA
    context: importing it, or running it as ``python -m``, loads neither
    torch nor JAX (the package root loads its names lazily)."""
    if how == "import":
        cmd = [sys.executable, "-c",
               "import sys, json, stoke_tpu_torch.supervise\n"
               "print(json.dumps(sorted(sys.modules)))"]
    else:
        # the worker prints what the supervisor process had loaded by then
        cmd = [sys.executable, "-c",
               "import sys, json, runpy\n"
               "sys.argv = ['supervise', '--max-restarts', '0', '--', "
               "sys.executable, '-c', 'pass']\n"
               "try:\n"
               "    runpy.run_module('stoke_tpu_torch.supervise', "
               "run_name='__main__')\n"
               "except SystemExit as e:\n"
               "    assert e.code == 0, e.code\n"
               "print(json.dumps(sorted(sys.modules)))"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    loaded = json.loads(out.strip().splitlines()[-1])
    # run as a module, it is __main__, beside the resilience module
    assert ("stoke_tpu_torch.supervise" in loaded) == (how == "import")
    assert "stoke_tpu_torch.resilience" in loaded
    assert "torch" not in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert bad == [], f"{path.name} imports {bad}"


NATIVE_SOURCES = sorted((ROOT / "stoke_tpu_torch").rglob("*.cpp"))


def test_the_port_has_its_own_batcher_source():
    assert [p.relative_to(ROOT).as_posix() for p in NATIVE_SOURCES] == [
        "stoke_tpu_torch/native/batcher.cpp"]


@pytest.mark.parametrize("path", NATIVE_SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in NATIVE_SOURCES])
def test_native_source_names_no_jax_package_path(path):
    """The port builds its own copy of the batcher, never the JAX
    package's source by path."""
    text = path.read_text()
    assert "stoke_tpu/" not in text and "stoke_tpu." not in text
