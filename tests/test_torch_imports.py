"""The port stands alone: no module of `repro_torch`, and neither
`chip_smoke.py` nor `chip_ab.py`, imports JAX or the JAX package
`repro`."""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro\s+import|from\s+repro\.)",
    re.MULTILINE,
)


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax():
    names = list(_port_modules()) + ["chip_smoke", "chip_ab"]
    assert "repro_torch.serving.serve_loop" in names
    code = (
        "import importlib, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('imported', len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py", "chip_ab.py"],
)
def test_source_has_no_jax_or_repro_import(path):
    assert not FORBIDDEN.findall((ROOT / path).read_text()), path


def test_scan_pattern_catches_what_it_should():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import quant")
    assert FORBIDDEN.search("    from repro import kernels")
    assert not FORBIDDEN.search("from repro_torch.core import quant")
    assert not FORBIDDEN.search("import repro_torch")


@pytest.mark.parametrize("module", [
    "repro_torch.configs", "repro_torch.configs.base", "repro_torch.configs.rwkv6_7b",
    "repro_torch.configs.qwen3_4b", "repro_torch.models.layers", "repro_torch.models.registry",
    "repro_torch.training.train_loop", "repro_torch.distributed.collectives",
    "repro_torch.launch", "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
    "repro_torch.launch.hillclimb", "repro_torch.launch.mesh", "repro_torch.distributed.sharding",
])
def test_the_dp_and_lm_modules_are_held_to_it(module):
    """The data-parallel collective, the LM side, its sharding rules, its
    meshes and its dry run are among the modules the two tests above
    import and scan."""
    assert module in set(_port_modules())
