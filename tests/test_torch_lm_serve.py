"""The port's serving path on the CPU: ``launch.serve.BatchServer`` on
ragged, left-padded prompts against the reference's ``BatchServer`` (the
same tokens), top-k temperature sampling (every token inside the top k of
its step's logits, the same tokens for the same seed), the CLI with
``--smoke --device cpu``, and the device rule (the card unless the caller
asks for the CPU)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.launch import serve as RS
from repro.models import model as RM
from repro_torch import configs as TC
from repro_torch.core.device import resolve_device
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = (24, 17, 31, 8)   # the serve_lm example's ragged prompts
NEW = 12


def _requests(mod, vocab, seed=0, **kw):
    rng = np.random.default_rng(seed)
    return [mod.Request(prompt=rng.integers(0, vocab, size=n
                                            ).astype(np.int32),
                        max_new=NEW - i, **kw)
            for i, n in enumerate(PROMPTS)]


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-9b",
                                  "mamba2-780m", "whisper-small"])
def test_batch_server_matches_reference(arch):
    """Window-8 rings under prompts of up to 31 tokens (gemma2,
    recurrentgemma), the SSM's recurrent prefill and whisper's zero
    frames; each request cut to its own ``max_new``."""
    cfg = RC.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray, RM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    want = RS.BatchServer(cfg, tree, max_len=256).serve(
        _requests(RS, cfg.vocab))
    tcfg = TC.get_smoke_config(arch)
    server = TS.BatchServer(tcfg, params_from_numpy(tcfg, tree,
                                                    device="cpu"),
                            max_len=256)
    got = server.serve(_requests(TS, tcfg.vocab))
    for w, g in zip(want, got):
        assert g.out.shape == (w.max_new,)
        np.testing.assert_array_equal(g.out, w.out)


@pytest.mark.parametrize("top_k", [1, 5])
def test_sampling_stays_in_top_k(top_k):
    """Temperature 0.8: every sampled token lies inside the top k of the
    logits it was drawn from (replayed by prefill and decode steps fed the
    sampled tokens); the same seed gives the same tokens; top_k = 1 is
    greedy."""
    cfg = TC.get_smoke_config("smollm-135m")
    model = TM.init_params(0, cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (3, 10)).astype(np.int32))
    run = dict(max_new=8, max_len=18, temperature=0.8, top_k=top_k)
    got = TM.generate(model, {"tokens": toks}, cfg, seed=7, **run)
    assert torch.equal(got, TM.generate(model, {"tokens": toks}, cfg,
                                        seed=7, **run))
    cache = TM.init_cache(cfg, 3, 18, device="cpu")
    last, cache, _ = TM.prefill(model, {"tokens": toks}, cfg, cache)
    for i in range(8):
        top = torch.topk(last, top_k, dim=-1).indices
        assert (top == got[:, i:i + 1].long()).any(dim=-1).all(), i
        last, cache = TM.decode_step(model, got[:, i:i + 1], 10 + i, cfg,
                                     cache)
    if top_k == 1:
        greedy = TM.greedy_generate(model, {"tokens": toks}, cfg, max_new=8,
                                    max_len=18)
        assert torch.equal(got, greedy)
    else:
        other = TM.generate(model, {"tokens": toks}, cfg, seed=8, **run)
        assert not torch.equal(got, other)


def test_batch_server_sampling_is_seeded():
    """Requests with a temperature: the server's runs draw from seed 0,
    as the reference's do, so two runs give the same tokens, inside the
    padded vocabulary and apart from greedy decoding."""
    cfg = TC.get_smoke_config("gemma2-2b")
    server = TS.BatchServer(cfg, TM.init_params(1, cfg, device="cpu"))

    def run(temperature):
        reqs = [TS.Request(prompt=np.arange(5 + i, dtype=np.int32),
                           max_new=6, temperature=temperature, top_k=20)
                for i in range(3)]
        return np.stack([r.out for r in server.serve(reqs)])
    sampled = run(1.0)
    np.testing.assert_array_equal(sampled, run(1.0))
    assert ((sampled >= 0) & (sampled < cfg.vocab_padded)).all()
    assert not np.array_equal(sampled, run(0.0))


def test_cli_serves_smoke_config_on_the_cpu():
    reqs = TS.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "9", "--max-new", "5"])
    assert len(reqs) == 2
    for r in reqs:
        assert r.out.shape == (5,)
        assert ((r.out >= 0) & (r.out < 512)).all()


def test_cli_module_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "smollm-135m", "--smoke", "--device", "cpu", "--max-new", "4"],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 4 requests x 4 tokens" in proc.stdout
    assert "req 1:" in proc.stdout


def test_entry_points_run_on_the_card_unless_asked():
    cfg = TC.get_smoke_config("smollm-135m")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        assert TM.init_params(0, cfg).embed.tok_embed.is_cuda
    else:
        for call in (lambda: resolve_device(None),
                     lambda: TM.init_params(0, cfg),
                     lambda: TM.init_cache(cfg, 1, 8),
                     lambda: TS.main(["--smoke"])):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert resolve_device("cpu").type == "cpu"


def test_profiled_device_time_counts_each_kernel_once():
    """The decode loop's device time in ``chip_smoke.py`` (phase 19) sums
    the events that ran on the card: a host op carries its kernel's time
    as well, and a device-side user annotation spans kernels."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    op = FunctionEvent(0, "aten::mm", 1, 0, 20, use_device="cuda")
    op.append_kernel("gemm", 0, 5)
    kernels = [FunctionEvent(i, "gemm", 7, 30 + 10 * i, 35 + 10 * i,
                             use_device="cuda", device_type=DeviceType.CUDA)
               for i in (1, 2)]
    note = FunctionEvent(3, "decode", 7, 30, 60, use_device="cuda",
                         device_type=DeviceType.CUDA,
                         is_user_annotation=True)
    assert op.self_device_time_total == 5
    assert chip_smoke.device_event_us([op, *kernels, note]) == 10.0
