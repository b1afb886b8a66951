"""Multi-PROCESS distributed trace: 2 jax.distributed processes x 4
virtual CPU devices = one 8-device global mesh over Gloo collectives.

This is the execution evidence for `parallel/distributed.py` (SURVEY.md
§5.8 "jax.distributed process bootstrap"): everything in
parallel/sharding.py is plain SPMD over whatever mesh it's handed, so
after `init_distributed()` the SAME engine call
(`Tracer.trace(mode="multichip")`) runs across process boundaries —
device_put scatters each process's addressable shards, `psum` rides the
distributed runtime, and the psum'd detector state / ledger come back
replicated to every process.

CPU-only on purpose: it is a virtual-device test. On a GPU machine two
such processes would each try to reserve the card, so every process here
runs with JAX_PLATFORMS=cpu.

Modes:
  python scripts/multiprocess_trace.py            # orchestrator: spawns
      the single-process 8-device reference, then 2 workers, and asserts
      the multi-process detected power / ledger MATCH the single-process
      run exactly (same global mesh shape, same interleave -> same
      per-shard reduction order).
  python scripts/multiprocess_trace.py --worker I --port P --out F
      # one jax.distributed process (internal)
  python scripts/multiprocess_trace.py --single --out F
      # single-process 8-device reference (internal)

The orchestrator exits nonzero on any mismatch. Wall-clock budget ~2 min
on a 1-core box (Gloo handshakes + 3 CPU compiles).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RAY_COUNT = int(os.environ.get("RAY_COUNT", 4096))
N_PROCESSES = 2
DEVICES_PER_PROCESS = 4


def _build_and_trace():
    """The workload every mode runs: BASELINE config-5-shaped scene
    (parabolic collimator + hemisphere detector), engine multichip path
    over ALL global devices."""
    import numpy as np

    import lightpycl_tpu as L
    from lightpycl_tpu.sources import LightSource
    from lightpycl_tpu.tracer.engine import Tracer

    oe = L.optical_elements(n_segments=32, n_radial=12)
    elements = [
        oe.parabolic_mirror(focus=0.5, diameter=2.0, reflectivity=0.98),
        oe.hemisphere(radius=8.0, material="measure", name="dome"),
    ]
    # from the focus INTO the dish: every ray reflects (0.98) before the
    # dome, so detected ~0.98 / absorbed ~0.02 witnesses real physics
    # across the process boundary, not a straight-to-detector pass
    src = LightSource(center=(0, 0, 0.5), direction=(0, 0, -1),
                      power=1.0, ray_count=RAY_COUNT, seed=7,
                      polar_max=np.pi / 2.4)
    res = Tracer().trace(src, elements, trace_iterations=4,
                         capacity=RAY_COUNT, mode="multichip")
    return {
        "detected": float(res.ledger["measured"]),
        "ledger": {k: float(v) for k, v in res.ledger.items()},
        "hist_total": float(np.asarray(res.hist).sum()),
        "accounted": float(sum(res.ledger[k] for k in
                               ("measured", "absorbed", "escaped",
                                "culled")) + res.final_live_power),
    }


def run_single(out_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    payload = _build_and_trace()
    payload["n_devices"] = len(jax.devices())
    payload["n_processes"] = 1
    with open(out_path, "w") as f:
        json.dump(payload, f)


def run_worker(process_id, port, out_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from lightpycl_tpu.parallel.distributed import init_distributed

    n_global = init_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=N_PROCESSES, process_id=process_id)
    assert jax.process_count() == N_PROCESSES, jax.process_count()
    assert n_global == N_PROCESSES * DEVICES_PER_PROCESS, n_global
    assert len(jax.local_devices()) == DEVICES_PER_PROCESS

    payload = _build_and_trace()
    payload["n_devices"] = n_global
    payload["n_processes"] = jax.process_count()
    payload["process_id"] = process_id
    # every process holds the psum'd (replicated) results; each writes its
    # own file so the orchestrator can assert cross-process agreement
    with open(out_path, "w") as f:
        json.dump(payload, f)


def orchestrate():
    env_base = dict(os.environ)
    env_base["PYTHONPATH"] = REPO + os.pathsep + env_base.get("PYTHONPATH", "")
    env_base["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={DEVICES_PER_PROCESS} "
        + env_base.get("XLA_FLAGS", "")).strip()
    tmp = tempfile.mkdtemp(prefix="lpcl_mp_")
    port = int(os.environ.get("LPCL_MP_PORT", 12431))

    # single-process 8-device reference: same global device count
    ref_env = dict(env_base)
    ref_env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count="
        f"{N_PROCESSES * DEVICES_PER_PROCESS} "
        + dict(os.environ).get("XLA_FLAGS", "")).strip()
    ref_out = os.path.join(tmp, "single.json")
    subprocess.run([sys.executable, __file__, "--single", "--out", ref_out],
                   env=ref_env, check=True, timeout=900)

    def _spawn_workers(port):
        procs, outs = [], []
        for i in range(N_PROCESSES):
            out = os.path.join(tmp, f"worker{i}.json")
            outs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--worker", str(i),
                 "--port", str(port), "--out", out],
                env=env_base))
        rcs = [p.wait(timeout=900) for p in procs]
        return rcs, outs

    rcs, outs = _spawn_workers(port)
    if any(rcs):
        # a stale listener on the coordinator port fails the bind; one
        # retry on a different port keeps the driver witness robust
        print(f"workers exited {rcs}; retrying on port {port + 7}",
              file=sys.stderr)
        rcs, outs = _spawn_workers(port + 7)
    if any(rcs):
        raise SystemExit(f"workers exited rc={rcs}")

    ref = json.load(open(ref_out))
    w = [json.load(open(o)) for o in outs]
    assert w[0]["n_processes"] == N_PROCESSES
    assert w[0]["n_devices"] == ref["n_devices"] == 8
    # replicated psum results must agree bit-for-bit across processes
    assert w[0]["detected"] == w[1]["detected"], (w[0], w[1])
    assert w[0]["ledger"] == w[1]["ledger"]
    # and match the single-process 8-device mesh exactly: same mesh
    # shape + same interleave -> identical per-shard reduction trees
    assert abs(w[0]["detected"] - ref["detected"]) <= 1e-6, (
        w[0]["detected"], ref["detected"])
    assert abs(w[0]["hist_total"] - ref["hist_total"]) <= 1e-5
    for k, v in ref["ledger"].items():
        assert abs(w[0]["ledger"][k] - v) <= 1e-6, (k, w[0]["ledger"], v)
    assert abs(w[0]["accounted"] - 1.0) <= 1e-4, w[0]["accounted"]
    print(json.dumps({
        "multiprocess": "ok",
        "n_processes": N_PROCESSES,
        "devices_per_process": DEVICES_PER_PROCESS,
        "detected": w[0]["detected"],
        "detected_single_process": ref["detected"],
        "ledger": w[0]["ledger"],
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--single", action="store_true")
    ap.add_argument("--port", type=int, default=12431)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if a.single:
        run_single(a.out)
    elif a.worker is not None:
        run_worker(a.worker, a.port, a.out)
    else:
        orchestrate()


if __name__ == "__main__":
    main()
