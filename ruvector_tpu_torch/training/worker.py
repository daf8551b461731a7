"""Background training worker with a job queue (the port's own copy of
ruvector_tpu/training/worker.py; pure Python).

Reference: ruvector-postgres/src/gnn/workers/gnn.rs:146-266 — a background
worker drains training jobs (collection, force flag), trains the GNN, and
publishes status + the trained model; SQL functions enqueue jobs and fetch
results (:313-345).

Here: a daemon thread drains TrainJobs, runs the contrastive trainer, and
exposes status/model via thread-safe accessors — the same enqueue/poll
discipline for serving processes that must never block on training.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import threading
import time
from typing import Any, Callable


class JobStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class TrainJob:
    job_id: int
    collection: str
    epochs: int = 1
    force: bool = False
    status: JobStatus = JobStatus.QUEUED
    error: str = ""
    loss: float | None = None
    submitted_at: float = dataclasses.field(default_factory=time.time)
    finished_at: float | None = None


class GnnTrainingWorker:
    """Job-queue training worker (workers/gnn.rs parity).

    train_fn(collection, epochs) -> (model, loss) supplied by the caller;
    the worker serializes runs, tracks per-collection models and statuses.
    train_fn runs on the worker thread (CUDA work there runs on the
    thread's current stream); an exception it raises, a CUDA error
    included, fails its job and leaves the worker running.
    """

    def __init__(self, train_fn: Callable[[str, int], tuple[Any, float]],
                 min_retrain_interval_s: float = 0.0):
        self._train_fn = train_fn
        self._queue: queue.Queue[TrainJob] = queue.Queue()
        self._jobs: dict[int, TrainJob] = {}
        self._models: dict[str, Any] = {}
        self._last_trained: dict[str, float] = {}
        self._lock = threading.Lock()
        self._next_id = 0
        self._min_interval = min_retrain_interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- enqueue/poll API (the SQL-function surface) -------------------------

    def enqueue(self, collection: str, epochs: int = 1,
                force: bool = False) -> int:
        """ruvector_gnn_train(collection, force) equivalent."""
        with self._lock:
            self._next_id += 1
            job = TrainJob(self._next_id, collection, epochs, force)
            self._jobs[job.job_id] = job
        self._queue.put(job)
        return job.job_id

    def status(self, job_id: int) -> TrainJob | None:
        with self._lock:
            return self._jobs.get(job_id)

    def model(self, collection: str):
        """Fetch the latest trained model (workers/gnn.rs:345)."""
        with self._lock:
            return self._models.get(collection)

    def wait(self, job_id: int, timeout: float = 60.0) -> TrainJob:
        deadline = time.time() + timeout
        while time.time() < deadline:
            job = self.status(job_id)
            if job and job.status in (JobStatus.DONE, JobStatus.FAILED):
                return job
            time.sleep(0.01)
        raise TimeoutError(f"job {job_id} did not finish")

    def shutdown(self):
        self._stop.set()
        self._queue.put(None)   # wake the worker
        self._thread.join(timeout=5)

    # -- worker loop ----------------------------------------------------------

    def _run(self):
        while not self._stop.is_set():
            job = self._queue.get()
            if job is None:
                continue
            with self._lock:
                last = self._last_trained.get(job.collection, 0.0)
                skip = (not job.force
                        and time.time() - last < self._min_interval)
            if skip:
                job.status = JobStatus.DONE
                job.error = "skipped: recently trained"
                job.finished_at = time.time()
                continue
            job.status = JobStatus.RUNNING
            try:
                model, loss = self._train_fn(job.collection, job.epochs)
                with self._lock:
                    self._models[job.collection] = model
                    self._last_trained[job.collection] = time.time()
                job.loss = float(loss)
                job.status = JobStatus.DONE
            except Exception as e:   # fail the job, keep the worker alive
                job.status = JobStatus.FAILED
                job.error = str(e)
            job.finished_at = time.time()
