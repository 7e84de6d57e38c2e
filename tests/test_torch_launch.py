"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU.

``synth_workload`` draws the paper's four workload shapes (§5.2) bit for
bit as the JAX package's launcher does, and ``main`` serves them with
compression firing, or with none under ``--full-kv``.
"""
import numpy as np
import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["amc", "gsm", "long", "mix"])
def test_synth_workload_equals_the_reference(kind, seed):
    want = jserve.synth_workload(kind, 16, 512,
                                 np.random.default_rng(seed))
    got = serve.synth_workload(kind, 16, 512, np.random.default_rng(seed))
    assert got == want
    assert all(isinstance(t, int) for p, o in got for t in p + [o])


@pytest.mark.parametrize("full_kv", [False, True])
def test_main_compresses_unless_full_kv(full_kv, capsys):
    argv = ["--arch", "tiny-lm", "--workload", "mix", "--n-requests", "8",
            "--device", "cpu"] + (["--full-kv"] if full_kv else [])
    res = serve.main(argv)
    assert res["device"] == "cpu"
    assert res["tokens"] > 0 and res["steps"] > 0
    if full_kv:
        assert res["compressions"] == 0
    else:
        assert res["compressions"] > 0
    assert '"compressions"' in capsys.readouterr().out


def test_a_reduced_arch_draws_prompts_from_its_own_vocabulary():
    res = serve.main(["--arch", "qwen3-8b", "--workload", "gsm",
                      "--n-requests", "4", "--device", "cpu"])
    assert res["tokens"] > 0 and res["peak_running"] == 4
