"""The port's multi-device layer across processes, on the CPU: the
distributed bring-up (``parallel.initialize_distributed``) against the JAX
package's under one fake clock and one injected fault, then two OS processes
over gloo, four logical ``cpu`` shards each, forming one 8-shard mesh
(``tests/test_multihost.py``'s layout).

The distributed train step must equal the single-process 8-shard step
exactly (global per-tree keys make the placement irrelevant, and the scores
are gathered before one ``exp2``); the 2-D scores exactly where a data row
stays inside one rank, and within 2e-6 where its partial sums meet in an
all-reduce (another sum order). A killed peer must give the typed
``DistributedTimeoutError`` naming the quiet peer within its deadline.

Hardened as the JAX package's suite: a hard host-side timeout on every
worker, the worker's own deadline watchdog with peer heartbeats
(``resilience/watchdog.py``), and every worker reaped on every exit path.
Run as ``__main__``, this file is the worker.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np

# the step's configuration, shared by the workers and the host test
STEP_KWARGS = dict(num_rows=512, num_features_total=4, num_trees=16, num_samples=64, num_features=4,
                   contamination=0.05)
SKETCH_ERROR = 0.02

# exit codes that name the failure mode: a typed deadline error is the
# designed outcome of a dead peer, any other crash is a bug
EXIT_TIMEOUT = 43
EXIT_DIED_EARLY = 44

HEARTBEAT_INTERVAL_S = 0.5
# the host's hard bound on a worker; the worker's own watchdog fires first
_HARD_TIMEOUT_S = 300


def _rows() -> np.ndarray:
    rng = np.random.default_rng(0)
    X = rng.normal(size=(512, 4)).astype(np.float32)
    X[:8] += 6.0
    return X


def run_steps(devices) -> dict:
    """The train step (exact and with the sketch) and the 2-D scores of its
    forest over a ``(data, trees)`` mesh of ``devices`` (this rank's) and,
    for the 2-D scores, a one-row ``(1, n)`` mesh too; numpy arrays."""
    import torch

    from isoforest_tpu_torch.ops import prng
    from isoforest_tpu_torch.parallel import create_mesh, make_train_step, sharded_score, sharded_score_2d

    X = _rows()
    mesh = create_mesh(devices)
    exact = make_train_step(mesh, **STEP_KWARGS)(prng.PRNGKey(0), X)
    sketch = make_train_step(mesh, **STEP_KWARGS, contamination_error=SKETCH_ERROR)(prng.PRNGKey(0), X)
    row_mesh = create_mesh(devices, data_parallelism=1)
    out = {f"forest_{i}": a.cpu().numpy() for i, a in enumerate(exact.forest)}
    out.update(
        scores=exact.scores.cpu().numpy(), threshold=float(exact.threshold),
        sketch_scores=sketch.scores.cpu().numpy(), sketch_threshold=float(sketch.threshold),
        sharded=sharded_score(mesh, exact.forest, X[:509], 64, "dense").cpu().numpy(),
        score_2d=sharded_score_2d(mesh, exact.forest, X[:509], 64, "walk").cpu().numpy(),
        score_2d_one_row=sharded_score_2d(row_mesh, exact.forest, X[:509], 64, "walk").cpu().numpy(),
    )
    assert isinstance(exact.scores, torch.Tensor)
    return out


def _worker_main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="one rank of the two-process test")
    parser.add_argument("proc_id", type=int)
    parser.add_argument("nprocs", type=int)
    parser.add_argument("port")
    parser.add_argument("out_path")
    parser.add_argument("--heartbeat-dir", required=True)
    parser.add_argument("--deadline-s", type=float, required=True)
    parser.add_argument("--die-early", action="store_true")
    args = parser.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from isoforest_tpu_torch.resilience.retry import DistributedTimeoutError
    from isoforest_tpu_torch.resilience.watchdog import (
        HeartbeatWriter,
        WatchdogTimeout,
        format_heartbeat_ages,
        peer_heartbeat_ages,
        run_with_deadline,
    )

    heartbeat = HeartbeatWriter(args.heartbeat_dir, f"proc{args.proc_id}", interval_s=HEARTBEAT_INTERVAL_S).start()
    if args.die_early:
        # visible to the peer (one heartbeat on disk), never joins
        heartbeat.stop()
        print(f"worker {args.proc_id}: dying before joining", flush=True)
        os._exit(EXIT_DIED_EARLY)

    def body() -> None:
        import torch.distributed as dist

        from isoforest_tpu_torch.parallel import initialize_distributed

        initialize_distributed(f"127.0.0.1:{args.port}", args.nprocs, args.proc_id, backend="gloo")
        out = run_steps([torch.device("cpu")] * 4)
        if args.proc_id == 0:
            np.savez(args.out_path, **out)
        dist.barrier()
        dist.destroy_process_group()

    def peers() -> str:
        return format_heartbeat_ages(peer_heartbeat_ages(args.heartbeat_dir), stale_after_s=4 * HEARTBEAT_INTERVAL_S)

    try:
        try:
            run_with_deadline(body, args.deadline_s, describe=f"multihost worker {args.proc_id} distributed body",
                              on_timeout=peers)
        except WatchdogTimeout as exc:
            raise DistributedTimeoutError(str(exc), deadline_s=args.deadline_s) from exc
    except DistributedTimeoutError as exc:
        print(f"worker {args.proc_id}: DistributedTimeoutError: {exc}", file=sys.stderr, flush=True)
        # the abandoned body may sit in a collective: skip the interpreter's teardown
        os._exit(EXIT_TIMEOUT)
    finally:
        heartbeat.stop()


if __name__ == "__main__":
    _worker_main()
    sys.exit(0)


import pytest  # noqa: E402
import torch  # noqa: E402

from isoforest_tpu_torch import telemetry  # noqa: E402
from isoforest_tpu_torch.resilience import faults  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(proc_id: int, port: int, out, hb_dir, deadline_s: float, *extra: str):
    root = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               ISOFOREST_TPU_AUTOTUNE="0", OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, str(pathlib.Path(__file__).resolve()), str(proc_id), "2", str(port), str(out),
         f"--heartbeat-dir={hb_dir}", f"--deadline-s={deadline_s}", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, start_new_session=True,
    )


def _reap(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:  # pragma: no cover - a kernel-level wedge
            pass


def _communicate_all(procs, timeout_s: float):
    logs = []
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            _reap(procs)
            pytest.fail(f"workers exceeded the {timeout_s:.0f}s host-side timeout; group killed")
        logs.append(stdout)
    return logs


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    out, hb_dir, port = tmp / "result.npz", tmp / "heartbeats", _free_port()
    procs = [_spawn(i, port, out, hb_dir, _HARD_TIMEOUT_S - 60) for i in range(2)]
    try:
        logs = _communicate_all(procs, _HARD_TIMEOUT_S)
    finally:
        _reap(procs)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-3000:]}"
    beats = sorted(f.name for f in hb_dir.glob("heartbeat-*.json"))
    assert beats == ["heartbeat-proc0.json", "heartbeat-proc1.json"]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def one_process_run():
    with torch_one_thread():
        return run_steps([torch.device("cpu")] * 8)


def torch_one_thread():
    from isoforest_tpu_torch.testing import torch_threads

    return torch_threads(1)


@pytest.mark.parametrize("name", ["forest_0", "forest_1", "forest_2", "scores", "threshold", "sketch_scores",
                                  "sketch_threshold", "sharded", "score_2d"])
def test_two_processes_equal_one_process(two_process_run, one_process_run, name):
    np.testing.assert_array_equal(two_process_run[name], np.asarray(one_process_run[name]))


def test_two_process_thresholds_and_row_subgroup_sum(two_process_run, one_process_run):
    from isoforest_tpu_torch.ops.quantile import quantile_rank_error

    scores = torch.from_numpy(two_process_run["scores"])
    assert quantile_rank_error(scores, float(two_process_run["threshold"]), 0.95) == 0
    err = quantile_rank_error(torch.from_numpy(two_process_run["sketch_scores"]),
                              float(two_process_run["sketch_threshold"]), 0.95)
    assert err <= max(int(SKETCH_ERROR * 512), 1)
    # one data row over both ranks: the partial sums meet in an all-reduce
    gap = np.abs(two_process_run["score_2d_one_row"] - one_process_run["score_2d_one_row"]).max()
    assert gap <= 2e-6


def test_killed_worker_yields_typed_timeout_not_hang(tmp_path):
    out, hb_dir, port = tmp_path / "unused.npz", tmp_path / "heartbeats", _free_port()
    deadline_s = 15.0
    procs = [_spawn(0, port, out, hb_dir, deadline_s), _spawn(1, port, out, hb_dir, deadline_s, "--die-early")]
    try:
        start = time.monotonic()
        logs = _communicate_all(procs, 120)
        elapsed = time.monotonic() - start
    finally:
        _reap(procs)
    assert procs[1].returncode == EXIT_DIED_EARLY, logs[1][-2000:]
    assert procs[0].returncode == EXIT_TIMEOUT, f"exit {procs[0].returncode}:\n{logs[0][-3000:]}"
    assert "DistributedTimeoutError" in logs[0] and "proc1" in logs[0], logs[0][-3000:]
    assert elapsed < 90, f"typed failure took {elapsed:.0f}s"
    assert not out.exists()


# -- the bring-up against the JAX package's (tests/test_resilience.py) -----


def _both_bringups(monkeypatch, fake, fault_count=None, policies=(None, None), **kwargs):
    """Run the port's and the JAX package's bring-up with ``fake(clock)`` in
    place of ``init_process_group`` and ``jax.distributed.initialize``, each
    under its own FakeClock and, with ``fault_count``, its own armed
    ``fail_distributed_init``; ``policies`` the two packages' retry
    policies. Returns ``[(error or None, sleeps, events, calls)]``, the
    port's first."""
    import jax
    import torch.distributed as dist

    from isoforest_tpu import telemetry as jax_telemetry
    from isoforest_tpu.parallel.mesh import initialize_distributed as jax_init
    from isoforest_tpu.resilience import faults as jax_faults
    from isoforest_tpu_torch.parallel import initialize_distributed

    results = []
    for init, patch_owner, patch_name, fault_mod, tele, policy in (
        (initialize_distributed, dist, "init_process_group", faults, telemetry, policies[0]),
        (jax_init, jax.distributed, "initialize", jax_faults, jax_telemetry, policies[1]),
    ):
        clock, calls = faults.FakeClock(), []
        monkeypatch.setattr(patch_owner, patch_name, lambda *a, **kw: (calls.append(kw), fake(clock)))
        last = max((e.seq for e in tele.get_events()), default=-1)
        error = None
        scope = fault_mod.inject(fail_distributed_init=fault_count) if fault_count is not None else _nothing()
        with scope:
            try:
                init(clock=clock.now, sleep=clock.sleep, retry_policy=policy, **kwargs)
            except Exception as exc:  # compared below
                error = exc
        events = [(e.kind, {k: v for k, v in e.fields.items() if k != "elapsed_s"})
                  for e in tele.get_events(since_seq=last) if e.kind.startswith(("distributed.", "retry."))]
        results.append((error, clock.sleeps, events, calls))
    return results


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def test_bringup_single_process_is_noop():
    from isoforest_tpu_torch.parallel import initialize_distributed

    initialize_distributed()
    initialize_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(num_processes=2, process_id=0)


def test_bringup_transient_failures_retried_as_in_jax(monkeypatch):
    port, ref = _both_bringups(monkeypatch, lambda clock: None, fault_count=2,
                               coordinator_address="10.0.0.1:8476", num_processes=4, process_id=1)
    assert port[0] is None and ref[0] is None
    assert len(port[3]) == len(ref[3]) == 1  # the first two attempts were the fault's
    assert port[3][0]["init_method"] == "tcp://10.0.0.1:8476" and port[3][0]["world_size"] == 4
    assert port[1] == ref[1] and len(port[1]) == 2 and port[1] == sorted(port[1])
    assert port[2] == ref[2]


def test_bringup_exhaustion_raises_typed_timeout_as_in_jax(monkeypatch):
    def never(clock):
        raise AssertionError("the fault consumes every attempt")

    port, ref = _both_bringups(monkeypatch, never, fault_count=99,
                               coordinator_address="10.0.0.1:8476", num_processes=4, process_id=1)
    assert type(port[0]).__name__ == type(ref[0]).__name__ == "DistributedTimeoutError"
    assert str(port[0]) == str(ref[0])
    for piece in ("coordinator=10.0.0.1:8476", "process_id=1", "attempts=3"):
        assert piece in str(port[0])
    assert port[1] == ref[1] and port[2] == ref[2] and port[3] == []


def test_bringup_deadline_bounds_whole_bringup_as_in_jax(monkeypatch):
    from isoforest_tpu.resilience import RetryPolicy as JaxRetryPolicy
    from isoforest_tpu_torch.resilience.retry import RetryPolicy

    def hang(clock):
        clock.advance(10.0)  # each attempt burns 10 virtual seconds
        raise RuntimeError("barrier timed out")

    knobs = dict(max_attempts=10, base_delay_s=4.0, jitter=0.0)
    port, ref = _both_bringups(monkeypatch, hang, policies=(RetryPolicy(**knobs), JaxRetryPolicy(**knobs)),
                               coordinator_address="x:1", num_processes=2, process_id=0, timeout_s=12.0)
    assert port[0].deadline_s == ref[0].deadline_s == 12.0
    # one 10 s attempt and a 4 s backoff overrun 12 s: abandoned after one attempt
    assert "attempts=1" in str(port[0]) and str(port[0]) == str(ref[0])
    assert port[1] == ref[1] == [] and port[2] == ref[2]
