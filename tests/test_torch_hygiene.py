"""The port's boundaries: its parameter dataclasses mirror the reference's
field for field, it imports neither jax nor the reference package, its
entry points refuse to fall back to the CPU silently, and `chip_smoke.py`
refuses to run without a card."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.configs import base as jbase
from repro.configs import qwen3_32b as jqwen
from repro.configs import zamba2_2p7b as jzamba2
from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.fl.simulator import FLSimConfig as JFLSimConfig
from repro_torch import resolve_device
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.configs import base
from repro_torch.configs import qwen3_32b as qwen
from repro_torch.configs import zamba2_2p7b as zamba2
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import ScenarioParams
from repro_torch.fl.simulator import FLSimConfig

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("ours,ref", [
    (ChannelParams, JChannel), (ManhattanParams, JManhattan),
    (VedsParams, JVeds), (ScenarioParams, JScenario),
    (FLSimConfig, JFLSimConfig)])
def test_parameter_dataclasses_match_reference(ours, ref):
    fo, fr = dataclasses.fields(ours), dataclasses.fields(ref)
    assert [f.name for f in fo] == [f.name for f in fr]
    assert ours() == ours(**dataclasses.asdict(ref()))
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    assert ours.__dataclass_params__.frozen
    if hasattr(ref, "noise_power"):
        assert ours().noise_power == ref().noise_power


@pytest.mark.parametrize("ours,ref", [
    (base.ModelConfig, jbase.ModelConfig),
    (base.ShapeConfig, jbase.ShapeConfig)])
def test_config_dataclasses_match_reference_field_for_field(ours, ref):
    fo, fr = dataclasses.fields(ours), dataclasses.fields(ref)
    assert [(f.name, f.default) for f in fo] == \
        [(f.name, f.default) for f in fr]
    assert ours.__dataclass_params__.frozen


def test_input_shapes_and_derived_config_values_match_reference():
    assert [dataclasses.asdict(s) for s in base.INPUT_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.INPUT_SHAPES]
    assert base.round_up(1000, 128) == jbase.round_up(1000, 128)
    cfg, ref = qwen.config(), jqwen.config()
    for name in ("num_layers", "d_inner", "ssm_heads", "q_per_kv"):
        assert getattr(cfg, name) == getattr(ref, name)
    assert cfg.effective_window(4096) == ref.effective_window(4096)
    assert str(cfg.dtype) == f"torch.{ref.dtype}"
    assert str(cfg.replace(param_dtype="float32").pdtype) == \
        "torch.float32"


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_qwen3_configs_match_reference_value_for_value(which):
    ours, ref = getattr(qwen, which)(), getattr(jqwen, which)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert qwen.ID == jqwen.ID
    got = (get_config if which == "config" else get_smoke_config)(qwen.ID)
    assert got == ours


@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_zamba2_configs_match_reference_value_for_value(which):
    ours, ref = getattr(zamba2, which)(), getattr(jzamba2, which)()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert zamba2.ID == jzamba2.ID
    for name in ("num_layers", "d_inner", "ssm_heads", "q_per_kv"):
        assert getattr(ours, name) == getattr(ref, name)
    got = (get_config if which == "config" else get_smoke_config)(zamba2.ID)
    assert got == ours


def test_registry_names_every_reference_arch_and_ports_qwen3_and_zamba2():
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        if arch in (qwen.ID, zamba2.ID):
            continue
        with pytest.raises(NotImplementedError, match="not ported"):
            get_config(arch)
        with pytest.raises(NotImplementedError, match="not ported"):
            get_smoke_config(arch)
    with pytest.raises(KeyError):
        get_config("gpt-2")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_files():
    return sorted(PORT.rglob("*.py"))


def test_port_imports_neither_jax_nor_reference_package():
    files = _port_files()
    assert len(files) >= 37
    for path in files + [ROOT / "chip_smoke.py"]:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), \
                (path.relative_to(ROOT), mod)


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in _port_files()]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_entry_points_default_to_cuda_and_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card_and_prints_no_result(tmp_path):
    """Without CUDA the script exits non-zero before any result; in a
    directory holding only the script it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        res = subprocess.run([sys.executable, str(script)],
                             cwd=script.parent, capture_output=True,
                             text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
