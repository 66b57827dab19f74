"""The MoE family's plain reference agrees with the port at a tiny size on
the CPU: the port's bulk prefill and decode steps (drop-free MoE, fp32
weights and state) against the reference's one forward over the whole
sequence, at every position."""

import torch
from chipbench import weights
from chipbench.spec import Bench

from chipbench.tests.tiny import tiny_config


def _port_logits(cfg, params, tokens, prompt_len):
    """The port's logits at positions prompt_len - 1 .. S - 2: a prefill of
    the first ``prompt_len`` tokens, then one decode step a token."""
    from repro_torch.models.model import decode_step, init_decode_state, prefill_forward

    b, s = tokens.shape
    lengths = torch.full((b,), prompt_len)
    logits, pstate = prefill_forward(cfg, params, tokens[:, :prompt_len], lengths,
                                     state_dtype=torch.float32, moe_cap=b * prompt_len * 8)
    state = init_decode_state(cfg, b, s, dtype=torch.float32, device="cpu")
    for name, new in pstate.items():
        state[name][tuple(slice(0, n) for n in new.shape)] = new
    out = [logits]
    for pos in range(prompt_len, s - 1):
        logits, state = decode_step(cfg, params, state, tokens[:, pos: pos + 1],
                                    torch.full((b,), pos), moe_cap=b * 8)
        out.append(logits)
    return torch.stack(out, dim=1)


def test_reference_agrees_with_the_port():
    from chipbench.harness import port_config
    from repro_torch.models.model import abstract_params

    c = tiny_config("deepseek-moe-16b")
    cfg = port_config(c)
    params = weights.draw(abstract_params(cfg, torch.float32), 7, torch.device("cpu"))
    prompt_len, s = 16, 22
    tokens = torch.randint(0, cfg.vocab, (3, s), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        port = _port_logits(cfg, params, tokens, prompt_len)
        ref = Bench().reference(c["family"]).forward(c, params, tokens[:, :-1])
    ref = ref[:, prompt_len - 1:]
    assert port.shape == ref.shape
    err = (port - ref).abs().max() / ref.abs().max()
    assert err < 1e-5, float(err)
    # and the comparison is not idle: the positions' logits differ
    assert (ref[:, 1:] - ref[:, :-1]).abs().max() > 1e-2


def test_reference_rounds_to_fp8_under_the_control():
    from chipbench.harness import port_config
    from repro_torch.models.model import abstract_params

    c = tiny_config("deepseek-moe-16b")
    params = weights.draw(abstract_params(port_config(c), torch.float32), 7,
                          torch.device("cpu"))
    tokens = torch.randint(0, c["vocab_size"], (2, 16), generator=torch.Generator().manual_seed(1))
    ref = Bench().reference(c["family"])
    with torch.no_grad():
        exact, low = ref.forward(c, params, tokens), ref.forward(c, params, tokens, "fp8")
    rel = (exact - low).abs().max() / exact.abs().max()
    assert 1e-3 < rel < 0.5, float(rel)
