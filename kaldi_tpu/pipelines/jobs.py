"""Job dispatch with failure detection, retries, and stage guards —
the run.pl / queue.pl role (SURVEY §5 failure-detection row: a mid-pipeline crash must not
lose the stage).

The reference's elasticity is coarse but effective: every stage is
idempotent and guarded (`--stage N`, `.done` markers), every job
writes `exp/*/log/<name>.<job>.log`, and queue.pl re-submits failed
jobs a bounded number of times, flagging the log of the final failure.
This module reproduces exactly that contract for Python callables:

  * ``stage(work, name)`` — a guard: returns False (skip) when the
    stage's `.done` marker exists; ``done()`` writes it.  Rerunning a
    crashed pipeline resumes at the first unguarded stage.
  * ``JobRunner.run(name, jobs)`` — runs the callables (a process
    fan-out in the reference; threads here, since the heavy work is
    inside jit/native code that releases the GIL), captures each
    job's log + exception, retries failures up to ``max_retries``,
    and raises with the failing log path if a job never succeeds —
    queue.pl's "check the per-job logfiles for status" behavior.
"""

from __future__ import annotations

import os
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

from kaldi_tpu.core.logging import KaldiError, get_logger

log = get_logger(__name__)


class stage:
    """Stage guard with a `.done` marker (the --stage/.done contract).

    Usage::

        with stage(work, "train_mono") as st:
            if st:             # not yet done
                ...            # do the work
        # marker written on clean exit; an exception leaves `.error`
    """

    def __init__(self, work_dir: str, name: str):
        self.dir = os.path.join(work_dir, ".stages")
        os.makedirs(self.dir, exist_ok=True)
        self.name = name
        self.done_path = os.path.join(self.dir, f"{name}.done")
        self.error_path = os.path.join(self.dir, f"{name}.error")

    @property
    def is_done(self) -> bool:
        return os.path.exists(self.done_path)

    def __enter__(self) -> bool:
        if self.is_done:
            log.info("stage %s: already done, skipping", self.name)
            return False
        if os.path.exists(self.error_path):
            os.remove(self.error_path)
        return True

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            if not self.is_done:
                with open(self.done_path, "w") as f:
                    f.write(f"{time.time()}\n")
        else:
            with open(self.error_path, "w") as f:
                f.write("".join(traceback.format_exception(
                    exc_type, exc, tb)))
            log.error("stage %s FAILED → %s", self.name,
                      self.error_path)
        return False                     # propagate exceptions


class JobRunner:
    """Parallel job fan-out with per-job logs and bounded retries
    (utils/queue.pl / run.pl)."""

    def __init__(self, log_dir: str, num_workers: int = 4,
                 max_retries: int = 1, retry_delay: float = 0.0):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.num_workers = num_workers
        self.max_retries = max_retries
        self.retry_delay = retry_delay

    def _run_one(self, name: str, job_id: int,
                 fn: Callable[[], object]):
        log_path = os.path.join(self.log_dir,
                                f"{name}.{job_id}.log")
        try:
            result = fn()
            with open(log_path, "a") as f:
                f.write(f"# Ended OK at {time.ctime()}\n")
            return (job_id, result, None, log_path)
        except Exception as e:           # captured per job, like a
            with open(log_path, "a") as f:   # nonzero exit status
                f.write("".join(traceback.format_exc()))
                f.write(f"# Ended with status 1 at {time.ctime()}\n")
            return (job_id, None, e, log_path)

    def run(self, name: str, jobs: Sequence[Callable[[], object]]
            ) -> List[object]:
        """Run all jobs; retry failures; return results in job order.
        Raises KaldiError naming the failing log after max retries."""
        results: Dict[int, object] = {}
        pending = list(enumerate(jobs))
        attempt = 0
        while pending:
            with ThreadPoolExecutor(self.num_workers) as pool:
                outs = list(pool.map(
                    lambda item: self._run_one(name, item[0], item[1]),
                    pending))
            failed = []
            for job_id, result, err, log_path in outs:
                if err is None:
                    results[job_id] = result
                else:
                    failed.append((job_id, err, log_path))
            if not failed:
                break
            attempt += 1
            if attempt > self.max_retries:
                job_id, err, log_path = failed[0]
                raise KaldiError(
                    f"{name}: {len(failed)} job(s) failed after "
                    f"{self.max_retries} retries; see {log_path} "
                    f"(first error: {err})")
            log.warning("%s: retrying %d failed job(s) (attempt %d/%d)",
                        name, len(failed), attempt, self.max_retries)
            if self.retry_delay:
                time.sleep(self.retry_delay)
            pending = [(job_id, jobs[job_id])
                       for job_id, _e, _l in failed]
        return [results[i] for i in range(len(jobs))]
