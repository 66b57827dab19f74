"""The PyTorch port's boundaries: it imports nothing of JAX or of the JAX
package, its copied modules equal their originals, and its entry points
refuse to fall back to the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import configs as jax_configs  # noqa: E402
from repro.configs import hpcc as jax_hpcc  # noqa: E402
from repro.models.model import param_shapes as jax_param_shapes  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.configs import hpcc as port_hpcc  # noqa: E402
from repro_torch.models import init_params, param_shapes  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine, ServeEngine  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.train.data import synthetic_batch  # noqa: E402
from repro_torch.weights import params_from_numpy  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
TWINS = [REPO / "examples" / "train_lm_torch.py", REPO / "examples" / "serve_lm_torch.py"]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "benchmarks" / "rmsnorm_ab_torch.py"] + TWINS
ARCHS = jax_configs.ARCH_IDS


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.serve, repro_torch.kernels\n"
        "import repro_torch.models, repro_torch.weights, repro_torch.obs\n"
        "import repro_torch.configs.hpcc, repro_torch.core, repro_torch.train\n"
        "import repro_torch.train.checkpoint, repro_torch.launch.train\n"
        "import repro_torch.dist, repro_torch.dist.sharding, repro_torch.dist.memmodel\n"
        "import repro_torch.core.torch_bridge, repro_torch.launch.mesh\n"
        "import repro_torch.launch.distributed_init, repro_torch.launch._torch_selftest\n"
        "import repro_torch.comm, repro_torch.core.dmat, repro_torch.core.ops\n"
        "import importlib.util\n"
        "for path in sys.argv[1:]:\n"
        "    spec = importlib.util.spec_from_file_location('twin', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import torch.distributed as dist\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
        "             or m.startswith(('jax.', 'repro.')))\n"
        "if dist.is_available() and dist.is_initialized():\n"
        "    bad.append('a torch.distributed process group')\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code, *map(str, TWINS)], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_file_of_the_port_imports_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "repro"), (
                f"{path.relative_to(REPO)}:{node.lineno} imports {name}"
            )


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    want = jax_configs.get_config(arch)
    got = port_configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert got.vocab_padded == want.vocab_padded
    for shape in jax_configs.SHAPES:
        assert port_configs.cell_applicable(got, shape) == jax_configs.cell_applicable(want, shape)


def test_hpcc_config_equals_the_reference():
    assert dataclasses.asdict(port_hpcc.config()) == dataclasses.asdict(jax_hpcc.config())


def test_shapes_and_arch_list_equal_the_reference():
    assert port_configs.ARCH_IDS == jax_configs.ARCH_IDS
    assert port_configs.list_archs() == jax_configs.list_archs()
    assert port_configs.all_cells() == jax_configs.all_cells()
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()
    }


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_reference(arch):
    for want_cfg, got_cfg in [
        (jax_configs.get_config(arch), port_configs.get_config(arch)),
        (jax_configs.get_config(arch).reduced(), port_configs.get_config(arch).reduced()),
    ]:
        assert param_shapes(got_cfg) == jax_param_shapes(want_cfg)
        assert got_cfg.param_count() == want_cfg.param_count()


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = port_configs.get_config("gemma-2b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatchingEngine(cfg, params, slots=1, max_seq=16, prefill_pad=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, max_seq=16).generate([[1, 2]], max_new=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"embed": params["embed"].numpy()})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batch(cfg, 2, 8, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--arch", "gemma-2b", "--reduced", "--steps", "1"])


def test_engine_refuses_an_unsupported_device():
    cfg = port_configs.get_config("gemma-2b").reduced()
    params = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ContinuousBatchingEngine(cfg, params, device="meta")


def _code_without_docstrings(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


COPIES = ["models/config.py", "serve/scheduler.py", "obs/metrics.py", "obs/trace.py",
          "core/pitfalls.py", "core/dmap.py", "core/redist.py", "core/dmat.py", "core/ops.py",
          "comm/context.py", "comm/collectives.py", "comm/threadcomm.py", "comm/frame.py",
          "comm/liveness.py", "comm/faultinject.py", "comm/filempi.py",
          "configs/__init__.py", "configs/hpcc.py"] + [
    f"configs/{a.replace('-', '_').replace('.', '_')}.py" for a in ARCHS
]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_equal_their_originals(rel):
    """The port's copies of pure-Python modules differ from the JAX
    package's only in their docstrings."""
    src = REPO / "src"
    assert _code_without_docstrings(src / "repro_torch" / rel) == (
        _code_without_docstrings(src / "repro" / rel)
    )
