"""Package rules of the PyTorch port: it imports neither ``jax`` nor the
JAX package, its entry points default to the card and raise without
one, ``chip_smoke.py`` refuses to run without a card or without the
repository, and every kernel source the loader builds is present."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import compat  # noqa: E402
from repro_torch.configs import ARCH_IDS, PORTED, get_config, smoke  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_torch_serving.py"] + sorted(
    (ROOT / "examples").glob("torch_*.py"))
#: the sharded slice's modules (ROADMAP item 13)
SHARDED_MODULES = ("repro_torch.distributed.sharding", "repro_torch.optim.grad_compress",
                   "repro_torch.launch.mesh", "repro_torch.launch.steps",
                   "repro_torch.launch.cost_analysis", "repro_torch.launch.dryrun",
                   "repro_torch.launch.train")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "repro"), f"{path.name} imports {mod}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")


def _entry_points():
    from repro_torch import models
    from repro_torch.convert import params_from_jax
    from repro_torch.models import attention, transformer
    from repro_torch.runtime import BatchedServer, ContinuousBatchingServer, ServingConfig

    cfg = smoke("deepseek_7b")
    return {
        "resolve_device": lambda: compat.resolve_device(),
        "init_params": lambda: models.init_params(cfg),
        "init_caches": lambda: models.init_caches(cfg, 1, 8),
        "init_period_cache": lambda: transformer.init_period_cache(cfg, 1, 8),
        "init_attn_cache": lambda: attention.init_attn_cache(cfg, cfg.period[0], 1, 8),
        "params_from_jax": lambda: params_from_jax({"w": [1.0]}),
        "ContinuousBatchingServer": lambda: ContinuousBatchingServer(cfg, {}, ServingConfig()),
        "BatchedServer": lambda: BatchedServer(cfg, {}, ServingConfig()),
    }


@pytest.mark.parametrize("name", ["resolve_device", "init_params", "init_caches",
                                  "init_period_cache", "init_attn_cache", "params_from_jax",
                                  "ContinuousBatchingServer", "BatchedServer"])
def test_entry_points_default_to_cuda_and_raise_without_a_card(name):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()


def test_cpu_is_used_only_when_asked():
    assert compat.resolve_device("cpu").type == "cpu"
    assert compat.resolve_device(torch.device("cpu")).type == "cpu"


def test_cache_builders_take_the_cpu_when_asked():
    from repro_torch.models import attention, init_caches, transformer

    cfg = smoke("deepseek_7b")
    trees = (attention.init_attn_cache(cfg, cfg.period[0], 1, 8, device="cpu"),
             transformer.init_period_cache(cfg, 1, 8, device="cpu"),
             init_caches(cfg, 1, 8, device="cpu"))

    def leaves(tree):
        return [t for v in tree.values() for t in (leaves(v) if isinstance(v, dict) else [v])]

    for tree in trees:
        assert leaves(tree) and all(t.device.type == "cpu" for t in leaves(tree))


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("name", compat.KERNEL_SOURCES)
def test_kernel_sources_present_and_build_dir_ignored(name):
    assert (compat.CSRC_DIR / f"{name}.cu").is_file()
    assert compat.BUILD_DIR.parent == ROOT / "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_only_ported_families_resolve():
    assert get_config("deepseek_7b").d_model == 4096
    # every family is ported: each resolves, and none waits on the ROADMAP
    assert set(PORTED) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert get_config(arch).n_layers > 0


def _run_chip_smoke(cwd: Path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_a_card():
    _no_card()
    res = _run_chip_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_chip_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_sharded_modules_import_no_process_group_state():
    """Importing the sharded slice's modules starts no process group and
    leaves torch's internal fake process group unimported (the dry-run
    loads it inside ``run_cell``)."""
    code = ("import sys, importlib\n"
            f"for m in {SHARDED_MODULES!r}: importlib.import_module(m)\n"
            "import torch.distributed as dist\n"
            "print(dist.is_initialized(), "
            "'torch.testing._internal.distributed.fake_pg' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "False"]


def test_every_reference_module_has_a_counterpart():
    """The module lists differ only by the port's own additions; the
    kernel packages have their own layout (a kernel's plain version and
    its ops live beside its wrapper), so there each package must exist."""
    ref = {p.relative_to(ROOT / "src" / "repro").as_posix()
           for p in (ROOT / "src" / "repro").rglob("*.py")}
    port = {p.relative_to(ROOT / "src" / "repro_torch").as_posix()
            for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    renamed = {"launch/hlo_analysis.py": "launch/cost_analysis.py"}
    missing = {m for m in ref - port if renamed.get(m) not in port
               and not (m.startswith("kernels/") and os.path.dirname(m) in
                        {os.path.dirname(q) for q in port})}
    assert not missing, sorted(missing)
