"""Package rules of the port: no module under ``src/repro_torch/`` and
not ``chip_smoke.py`` imports jax or the reference package, and the
entry points refuse to run without a device when no CUDA card exists."""
import ast
import pathlib

import pytest
import torch

from repro_torch import configs
from repro_torch.core.comm import Communicator
from repro_torch.mesh import RankAxis, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

# the suite runs in parallel worker processes: one intra-op thread each
# keeps these tests from crowding the other workers' cores
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    assert path.exists()
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_entry_points_need_a_device_without_cuda():
    """device=None means the CUDA card; with none, every entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    params = tf.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params, ServeConfig(batch=2, max_kv=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Communicator("model", n=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RankAxis("model", 2)


def test_rank_axis_shards_and_replicates():
    ax = RankAxis("model", 4, "cpu")
    x = torch.arange(24.0).reshape(2, 12)
    s = ax.shard(x, 1)
    assert s.shape == (4, 2, 3)
    assert torch.equal(s[2], x[:, 6:9])
    r = ax.replicate(x)
    assert r.shape == (4, 2, 12) and torch.equal(r[3], x)
    assert ax.index().tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="does not divide"):
        ax.shard(x, 0)
