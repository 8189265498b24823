"""The port's boundaries: its parameter dataclasses mirror the reference's
field for field, it imports neither jax nor the reference package, its
entry points refuse to fall back to the CPU silently, and `chip_smoke.py`
refuses to run without a card."""
import ast
import dataclasses
import importlib
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
from repro.core.scenario import FleetState as JFleetState
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.streaming import StreamConfig as JStreamConfig
from repro.fl.engine import ClientShards as JClientShards
from repro.fl.simulator import FLSimConfig as JFLSimConfig
from repro.launch.serve import ServeConfig as JServeConfig
from repro.launch.serve import ServeRequest as JServeRequest
from repro.launch.serve import ServeResponse as JServeResponse
from repro.sharding.rules import LogicalRules as JLogicalRules
from repro_torch import resolve_device
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.configs import base
from repro_torch.configs import qwen3_32b as qwen
from repro_torch.configs import zamba2_2p7b as zamba2
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import FleetState, ScenarioParams
from repro_torch.core.streaming import StreamConfig
from repro_torch.fl.engine import ClientShards
from repro_torch.fl.simulator import FLSimConfig
from repro_torch.launch.serve import (SchedulingService, ServeConfig,
                                      ServeRequest, ServeResponse,
                                      default_problem, request_draws)
from repro_torch.sharding.rules import LogicalRules

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("ours,ref", [
    (ChannelParams, JChannel), (ManhattanParams, JManhattan),
    (VedsParams, JVeds), (ScenarioParams, JScenario),
    (FLSimConfig, JFLSimConfig), (StreamConfig, JStreamConfig),
    (ServeConfig, JServeConfig)])
def test_parameter_dataclasses_match_reference(ours, ref):
    fo, fr = dataclasses.fields(ours), dataclasses.fields(ref)
    assert [f.name for f in fo] == [f.name for f in fr]
    assert ours() == ours(**dataclasses.asdict(ref()))
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())
    assert ours.__dataclass_params__.frozen
    if hasattr(ref, "noise_power"):
        assert ours().noise_power == ref().noise_power
    if hasattr(ref, "horizons"):
        assert (ours().horizons, ours().occupancies) == \
            (ref().horizons, ref().occupancies)


@pytest.mark.parametrize("ours,ref", [
    (ServeRequest, JServeRequest), (ServeResponse, JServeResponse)])
def test_serving_records_match_reference_field_for_field(ours, ref):
    fo, fr = dataclasses.fields(ours), dataclasses.fields(ref)
    assert [(f.name, f.default) for f in fo] == \
        [(f.name, f.default) for f in fr]
    assert ours.__dataclass_params__.frozen == ref.__dataclass_params__.frozen


@pytest.mark.parametrize("ours,ref", [
    (FleetState, JFleetState), (ClientShards, JClientShards)])
def test_state_dataclasses_match_reference_field_for_field(ours, ref):
    """The tensor containers of the streaming path: the same fields in
    the same order, frozen."""
    assert [f.name for f in dataclasses.fields(ours)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert ours.__dataclass_params__.frozen


def test_logical_rules_match_reference_field_for_field():
    """`LogicalRules`: the same fields, frozen as the reference's; its
    table is held entry for entry in `tests/test_torch_sharding_rules.py`."""
    fo, fr = dataclasses.fields(LogicalRules), dataclasses.fields(
        JLogicalRules)
    assert [(f.name, f.default) for f in fo] == \
        [(f.name, f.default) for f in fr]
    assert LogicalRules.__dataclass_params__.frozen
    assert JLogicalRules.__dataclass_params__.frozen
    assert [m for m in vars(LogicalRules) if not m.startswith("_")] == \
        [m for m in vars(JLogicalRules) if not m.startswith("_")]


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


@pytest.mark.parametrize("name", ["granite_moe_1b", "llama4_scout",
                                  "starcoder2_15b", "codeqwen_7b",
                                  "minitron_4b", "xlstm_1p3b",
                                  "whisper_small", "llama32_vision_90b"])
@pytest.mark.parametrize("which", ["config", "smoke_config"])
def test_zoo_configs_match_reference_value_for_value(name, which):
    """The MoE, dense, xLSTM, encoder-decoder and vlm configurations: each
    module's configs equal the reference's field for field, and the
    registry hands them out."""
    ours = importlib.import_module(f"repro_torch.configs.{name}")
    ref = importlib.import_module(f"repro.configs.{name}")
    assert ours.ID == ref.ID
    got, want = getattr(ours, which)(), getattr(ref, which)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (get_config if which == "config" else get_smoke_config)(
        ours.ID) == got


def test_registry_names_every_reference_arch_and_ports_qwen3_and_zamba2():
    """Every id of the reference's registry is ported: qwen3-32b,
    zamba2-2.7b, the MoE granite and llama4-scout, the dense starcoder2,
    codeqwen and minitron, and the xLSTM, whisper and vlm configs; an
    unknown id raises KeyError, as the reference's does."""
    assert ARCH_IDS == J_ARCH_IDS
    ported = {qwen.ID, zamba2.ID, "granite-moe-1b-a400m",
              "llama4-scout-17b-a16e", "starcoder2-15b", "codeqwen1.5-7b",
              "minitron-4b", "xlstm-1.3b", "whisper-small",
              "llama-3.2-vision-90b"}
    assert set(ARCH_IDS) == ported and len(ARCH_IDS) == 10
    for arch in ported:
        assert get_config(arch).name == get_smoke_config(arch).name == arch
    with pytest.raises(KeyError):
        get_config("gpt-2")
    with pytest.raises(KeyError):
        get_smoke_config("gpt-2")


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
    assert len(files) >= 61
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


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_pins_the_references_axes_and_shape(monkeypatch,
                                                            multi_pod):
    """`launch/mesh.py:make_production_mesh`'s topology is the
    reference's: the shape and axis names its `jax.make_mesh` call asks
    for (read without building 512 devices), and the port's fake world
    gives a `DeviceMesh` of them."""
    from repro.launch import mesh as jmesh
    from repro_torch.launch.mesh import (PRODUCTION_MESHES,
                                         make_production_mesh)
    monkeypatch.setattr(jmesh.jax, "make_mesh",
                        lambda shape, axes, **_: (tuple(shape), tuple(axes)))
    assert jmesh.make_production_mesh(multi_pod=multi_pod) == \
        PRODUCTION_MESHES[multi_pod]
    with make_production_mesh(multi_pod, device="cpu") as mesh:
        assert (tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names)) == \
            PRODUCTION_MESHES[multi_pod]


def test_dryrun_defaults_to_cuda_and_refuses_to_fall_back(monkeypatch):
    """The dry run's device is CUDA unless named: without one it raises
    before any case, as the entry points do."""
    from repro_torch.launch import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.run_case("minitron-4b", "decode_32k", False, "/nonexistent",
                        force=True)


def _builders():
    from repro_torch.core import scenario as scn
    from repro_torch.core.solver import p4_seed_table
    from repro_torch.data.synthetic import pad_client_shards
    sc, mob = ScenarioParams(n_sov=2, n_opv=2, n_slots=3), ManhattanParams()
    data = [{"x": torch.zeros(2, 3)}, {"x": torch.ones(1, 3)}]
    return {
        "make_round_batch": lambda d: scn.make_round_batch(
            3, sc, mob, ChannelParams(), VedsParams(), 1, device=d).g_sr,
        "init_fleet": lambda d: scn.init_fleet(3, sc, mob, 1,
                                               device=d).pos,
        "rsu_grid": lambda d: scn.rsu_grid(2, mob, device=d),
        "p4_seed_table": lambda d: p4_seed_table((2, 3), 1.0, device=d),
        "pad_client_shards": lambda d: pad_client_shards(data, d)[1],
        "ClientShards.from_ragged": lambda d: ClientShards.from_ragged(
            data, d).n_samples,
        "default_problem": lambda d: default_problem(2, device=d)[0]["w"],
        "request_draws": lambda d: request_draws(0, 2, 4, 2, 3, d)[1],
        "SchedulingService": lambda d: SchedulingService(
            ServeConfig(batch=1, max_rounds=1), device=d).shards.n_samples}


@pytest.mark.parametrize("name", sorted(_builders()))
def test_builders_default_to_cuda_and_refuse_to_fall_back(monkeypatch,
                                                          name):
    """The public builders place their tensors on CUDA unless the caller
    names another device, as the entry points do."""
    build = _builders()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(None)
    assert build("cpu").device == torch.device("cpu")


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
