"""The port's serving launcher (``python -m repro_torch.launch.serve``)
on the CPU: the one-shot path prints the ``seq0`` an ``Engine`` driven
directly gives on the same seeded weights and prompts, the router path
serves every request of the reference's seeded trace with none dropped,
an encoder architecture is refused, and the reference's ``--dp`` is not
taken."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import serve as launch
from repro_torch.models import transformer as tf
from repro_torch.serve.engine import Engine, ServeConfig

torch.set_num_threads(1)

ARGS = ["--arch", "qwen3-1.7b", "--reduced", "--device", "cpu", "--tp", "2",
        "--batch", "2", "--prompt-len", "4", "--tokens", "5",
        "--max-kv", "32"]


@pytest.mark.parametrize("mode", ["auto", "explicit"])
def test_one_shot_prints_the_engines_tokens(mode, capsys):
    assert launch.main(ARGS + ["--mode", mode]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and f"mode={mode}" in lines[0]
    cfg = configs.reduced(configs.get_config("qwen3-1.7b"))
    params = tf.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = Engine(cfg, params, ServeConfig(batch=2, max_kv=32, mode=mode),
                 tp=2, device="cpu")
    prompts = np.random.RandomState(0).randint(
        0, cfg.vocab, (2, 4)).astype(np.int32)
    out = eng.decode(eng.prefill(prompts), num_tokens=5)
    assert lines[1] == f"seq0: {out[0][:12].tolist()}"


def test_layers_cut_the_depth(capsys):
    assert launch.main(ARGS + ["--layers", "1", "--mode", "explicit"]) == 0
    assert "mode=explicit" in capsys.readouterr().out


def test_router_serves_every_request(tmp_path, capsys):
    assert launch.main(ARGS + ["--mode", "explicit", "--replicas", "2",
                               "--requests", "6", "--plan-dir",
                               str(tmp_path)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "modes=['explicit', 'explicit'] degraded=[]" in lines[0]
    assert "served 6/6 requests (0 dropped)" in lines[1]
    assert lines[2].startswith("req0: [")
    assert (tmp_path / "manifest.json").exists() or any(tmp_path.iterdir())


def test_encoder_arch_is_refused():
    with pytest.raises(SystemExit, match="encoder-only"):
        launch.main(["--arch", "hubert-xlarge", "--device", "cpu"])


def test_dp_is_not_taken(capsys):
    with pytest.raises(SystemExit):
        launch.main(ARGS + ["--dp", "2"])
    assert "--dp" in capsys.readouterr().err


def test_default_device_is_the_card(monkeypatch):
    """Without ``--device`` the launcher asks for the CUDA card and, where
    there is none, raises before building anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["--arch", "qwen3-1.7b", "--reduced"])


def test_flags_match_the_reference_launcher():
    """Every flag of the reference's launcher but ``--dp`` (a replica has
    no data axis; replicas are the router's)."""
    import ast
    import pathlib
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
           / "launch" / "serve.py").read_text()
    ref = {node.args[0].value for node in ast.walk(ast.parse(src))
           if isinstance(node, ast.Call)
           and getattr(node.func, "attr", None) == "add_argument"}
    mine = {a.option_strings[0] for a in launch._parser()._actions
            if a.option_strings and a.option_strings[0] != "-h"}
    assert ref - {"--dp"} <= mine
    assert "--dp" not in mine
    assert mine - ref == {"--device", "--layers"}
