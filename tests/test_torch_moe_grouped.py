"""``repro_torch.kernels.moe_grouped`` on the CPU: the parts of the
grouped expert GEMM that need no card.

The device-side tile schedule (``tile_schedule`` and the row starts the
kernels compute from it) against a plain Python schedule, for random,
skewed and empty-expert ``bounds``; the tile choice; ``moe_ffn``'s path
choice (drop-free with no gradient to the grouped wrapper, a capacity
under T·k, a gradient or training's capacity to the padded buffers),
with the same bits either way on the CPU; and the ``rows`` the layer's
regions carry.  The kernels themselves run on the card
(``tests/test_torch_gpu.py``)."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import moe_grouped as mg  # noqa: E402
from repro_torch.models import init_params, moe  # noqa: E402
from repro_torch.obs import trace  # noqa: E402


def _python_schedule(bounds: list, block_m: int) -> list:
    """(expert, first row, end row) of every tile, expert by expert."""
    tiles = []
    for e in range(len(bounds) - 1):
        for start in range(bounds[e], bounds[e + 1], block_m):
            tiles.append((e, start, min(start + block_m, bounds[e + 1])))
    return tiles


def _device_schedule(bounds: torch.Tensor, block_m: int) -> tuple[list, int]:
    """The tiles as the kernels read ``tile_schedule``: each program's
    expert, first row (``bounds[e] + (i - ends[e] + tiles_e) * block_m``)
    and end row; and how many programs of the grid had a tile."""
    e_count = bounds.numel() - 1
    grid = mg.n_tiles(int(bounds[-1]), e_count, block_m)
    expert, ends = mg.tile_schedule(bounds, block_m, grid)
    assert expert.shape == (grid,) and ends.shape == (e_count,)
    tiles = []
    for i, e in enumerate(expert.tolist()):
        if e >= e_count:
            continue
        lo, hi = int(bounds[e]), int(bounds[e + 1])
        first = int(ends[e]) - (hi - lo + block_m - 1) // block_m
        start = lo + (i - first) * block_m
        tiles.append((e, start, min(start + block_m, hi)))
    # every program past the real tiles is past the last expert
    assert expert[len(tiles):].eq(e_count).all()
    return tiles, grid


def _bounds(flat: torch.Tensor, e: int) -> torch.Tensor:
    order = torch.argsort(flat, stable=True)
    return torch.searchsorted(flat[order], torch.arange(e + 1))


ROUTINGS = ["random", "one_expert", "last_expert", "half_empty", "no_pairs"]


@pytest.mark.parametrize("block_m", [16, 64, 128])
@pytest.mark.parametrize("routing", ROUTINGS)
@pytest.mark.parametrize("seed", range(3))
def test_the_device_schedule_is_the_python_schedule(routing, block_m, seed):
    g = torch.Generator().manual_seed(seed)
    e = [64, 7, 128][seed]
    pairs = [288, 1000, 36864][seed] if routing != "no_pairs" else 0
    flat = {
        "random": lambda: torch.randint(0, e, (pairs,), generator=g),
        "one_expert": lambda: torch.zeros(pairs, dtype=torch.int64),
        "last_expert": lambda: torch.full((pairs,), e - 1),
        "half_empty": lambda: torch.randint(0, (e + 1) // 2, (pairs,), generator=g) * 2,
        "no_pairs": lambda: torch.zeros(0, dtype=torch.int64),
    }[routing]()
    bounds = _bounds(flat, e)
    tiles, grid = _device_schedule(bounds, block_m)
    assert tiles == _python_schedule(bounds.tolist(), block_m)
    assert len(tiles) <= grid


def test_the_tiles_follow_the_capacity_an_expert():
    """deepseek-moe-16b's served caps: an admission's 36,864 pairs take
    128-row tiles, a decode step's 288 the smallest, 16; fp32 stops at 64;
    the tile's other sizes are fixed per row count in the CUDA source."""
    assert mg.block_m(36864, 64, torch.bfloat16) == 128
    assert mg.block_m(288, 64, torch.bfloat16) == 16
    assert mg.block_m(3072, 64, torch.bfloat16) == 64
    assert mg.block_m(1536, 64, torch.bfloat16) == 32
    assert mg.block_m(36864, 64, torch.float32) == 64
    assert mg.block_m(32, 4, torch.float32) == 16


def test_the_launched_rows_of_the_served_shapes():
    """``rows`` on the grouped path: (ceil(T·k / BLOCK_M) + E) · BLOCK_M."""
    assert mg.tile_rows(36864, 64, 36864, torch.bfloat16) == (288 + 64) * 128
    assert mg.tile_rows(288, 64, 288, torch.bfloat16) == (18 + 64) * 16
    assert mg.tile_rows(100, 64, 288, torch.bfloat16) == (7 + 64) * 16


def _layer(cfg, seed=3):
    p = init_params(cfg, seed, dtype=torch.float32, device="cpu")["layers"]["moe"]

    def first(t):
        return {k: first(v) if isinstance(v, dict) else v[0] for k, v in t.items()}

    return first(p)


@pytest.fixture
def calls(monkeypatch):
    """The grouped wrapper's calls, each (pairs, cap)."""
    seen = []
    real = mg.expert_glu

    def spy(tokens, order, *a, **kw):
        seen.append((order.numel(), a[5]))
        return real(tokens, order, *a, **kw)

    monkeypatch.setattr(moe.moe_grouped, "expert_glu", spy)
    return seen


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("case", ["drop_free", "over_cap", "no_grad_over_cap"])
def test_drop_free_calls_without_grad_take_the_grouped_path(calls, arch, case):
    cfg = get_config(arch).reduced()
    t = 6
    pairs = t * cfg.moe_top_k
    cap = {"drop_free": pairs, "over_cap": 2 * pairs, "no_grad_over_cap": pairs + 1}[case]
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with torch.no_grad() if case == "no_grad_over_cap" else torch.enable_grad():
        moe.moe_ffn(cfg, _layer(cfg), x, cap=cap)
    assert calls == [(pairs, cap)]


@pytest.mark.parametrize("case", ["under_cap", "training_cap", "grad_input", "grad_weights"])
def test_capacity_limits_and_gradients_keep_the_buffers(calls, case):
    cfg = get_config("deepseek-moe-16b").reduced()
    p = _layer(cfg)
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator().manual_seed(2))
    pairs = 6 * cfg.moe_top_k
    cap = {"under_cap": pairs - 1, "training_cap": None}.get(case, pairs)
    if case == "grad_input":
        x.requires_grad_(True)
    if case == "grad_weights":
        p["experts"]["w_down"].requires_grad_(True)
    y, aux = moe.moe_ffn(cfg, p, x, cap=cap)
    assert calls == []
    if case.startswith("grad"):
        (y.sum() + aux).backward()


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("cap", ["drop_free", "above"])
def test_the_grouped_path_gives_the_buffer_paths_bits_on_the_cpu(calls, arch, cap):
    """The wrapper's plain version is the buffer path's arithmetic: the
    same output and aux loss, bit for bit, as the buffers under autograd."""
    cfg = get_config(arch).reduced()
    p = _layer(cfg)
    x = torch.randn(3, 5, cfg.d_model, generator=torch.Generator().manual_seed(4))
    c = 15 * cfg.moe_top_k + (0 if cap == "drop_free" else 9)
    with torch.no_grad():
        y, aux = moe.moe_ffn(cfg, p, x, cap=c)
    assert len(calls) == 1
    want_y, want_aux = moe.moe_ffn(cfg, p, x.clone().requires_grad_(True), cap=c)
    assert len(calls) == 1
    assert torch.equal(y, want_y.detach()) and torch.equal(aux, want_aux.detach())


def test_the_wrapper_takes_the_silu_glu_only():
    cfg = get_config("deepseek-moe-16b").reduced()
    ew = _layer(cfg)["experts"]
    tokens = torch.randn(2, cfg.d_model)
    order, bounds = torch.arange(4), torch.tensor([0, 1, 2, 3, 4])
    with pytest.raises(ValueError, match="silu GLU"):
        mg.expert_glu(tokens, order, bounds, ew["w_gate"], ew["w_up"], ew["w_down"], 2, 4,
                      "gelu_glu")


@pytest.fixture
def traced():
    trace.enable_trace()
    trace.reset_trace()
    try:
        yield
    finally:
        trace.disable_trace()
        trace.reset_trace()


@pytest.mark.parametrize("cap", ["drop_free", "under_cap"])
def test_the_regions_count_the_rows_each_path_computes(traced, cap):
    """Grouped: the launched tiles' rows, (ceil(T·k / 16) + E) · 16 here;
    buffers: E · (cap + 1)."""
    cfg = get_config("deepseek-moe-16b").reduced()
    t, k, e = 6, cfg.moe_top_k, cfg.n_experts
    c = t * k if cap == "drop_free" else t * k - 2
    with torch.no_grad():
        moe.moe_ffn(cfg, _layer(cfg), torch.randn(2, 3, cfg.d_model), cap=c)
    want = (-(-t * k // 16) + e) * 16 if cap == "drop_free" else e * (c + 1)
    got = [ev[4] for ev in trace.events() if ev[0].startswith("moe.")]
    assert got == [{"tokens": t, "pairs": t * k, "rows": want}] * 3


def test_the_cost_counts_the_pairs_and_the_experts_used():
    c = mg.cost(6144, 36864, 64, 2048, 1408)
    assert c["flops"] == c["operations"] == 6 * 36864 * 2048 * 1408
    assert c["bytes"] == 2 * (6144 * 2048 + 3 * 64 * 2048 * 1408 + 36864 * 2048) + 8 * 36864
    assert mg.cost(48, 288, 40, 2048, 1408, torch.float32)["bytes"] == (
        4 * (48 * 2048 + 3 * 40 * 2048 * 1408 + 288 * 2048) + 8 * 288)
