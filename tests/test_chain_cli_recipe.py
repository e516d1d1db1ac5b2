"""Chain recipe through the CLI tool layer only:
every stage a TOOLS call with ark/scp artifacts between — egs
extraction → nnet3-chain-train → compile-graph → nnet3-latgen-faster
→ scoring.  Plus the jobs.py failure-detection/stage-guard layer."""

import os

import numpy as np
import pytest

from kaldi_tpu.core.logging import KaldiError
from kaldi_tpu.pipelines.jobs import JobRunner, stage


@pytest.mark.slow
def test_chain_cli_recipe_end_to_end(tmp_path):
    from kaldi_tpu.pipelines.chain_cli_recipe import run
    wer = run(str(tmp_path), num_utts=40, num_test=10, mono_iters=8,
              chain_epochs=10, hidden=48)
    # artifacts on disk between every stage
    assert os.path.exists(tmp_path / "exp/mono/final.mdl")
    assert os.path.exists(tmp_path / "exp/chain/egs.ark")
    assert os.path.exists(tmp_path / "exp/chain/final.raw")
    assert os.path.exists(tmp_path / "exp/chain/graph/HCLG.fst")
    assert os.path.exists(tmp_path / "exp/chain/decode_test/lat.1.ark")
    assert wer.wer < 25.0


def test_stage_guard_skips_done(tmp_path):
    calls = []
    for _ in range(2):
        with stage(str(tmp_path), "s1") as todo:
            if todo:
                calls.append(1)
    assert calls == [1]                  # second run skipped
    assert os.path.exists(tmp_path / ".stages/s1.done")


def test_stage_guard_records_error(tmp_path):
    with pytest.raises(ValueError):
        with stage(str(tmp_path), "s2") as todo:
            assert todo
            raise ValueError("boom")
    err = tmp_path / ".stages/s2.error"
    assert err.exists() and "boom" in err.read_text()
    # stage not marked done → rerunnable
    with stage(str(tmp_path), "s2") as todo:
        assert todo
    assert (tmp_path / ".stages/s2.done").exists()
    assert not err.exists()              # cleared on the clean rerun


def test_jobrunner_retries_flaky_job(tmp_path):
    attempts = {"n": 0}

    def flaky():
        attempts["n"] += 1
        if attempts["n"] < 2:
            raise RuntimeError("transient")
        return "ok"

    runner = JobRunner(str(tmp_path / "log"), num_workers=2,
                       max_retries=2)
    results = runner.run("flaky", [lambda: 1, flaky, lambda: 3])
    assert results == [1, "ok", 3]
    assert attempts["n"] == 2
    # per-job logs exist (the queue.pl logfile contract)
    logs = os.listdir(tmp_path / "log")
    assert any(l.startswith("flaky.1") for l in logs)


def test_jobrunner_raises_with_log_path(tmp_path):
    def dead():
        raise RuntimeError("permanent")

    runner = JobRunner(str(tmp_path / "log"), max_retries=1)
    with pytest.raises(KaldiError, match="failed after 1 retries"):
        runner.run("dead", [dead])
    log_file = tmp_path / "log" / "dead.0.log"
    assert "permanent" in log_file.read_text()
