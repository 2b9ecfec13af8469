"""Kill-and-resume exactness check of the PyTorch port.

Runs ``python -m repro_torch.launch.partition`` three times against the same
dataset and seed, on ``--device`` (cpu or cuda):

  1. **reference** — an uninterrupted run, final labels written through
     ``--labels-out``;
  2. **victim** — the same command line with ``--checkpoint-dir`` and a
     ``REPRO_FAULTS=kill@superstep=N`` plan, so the process SIGKILLs itself
     mid-run (a real ``os.kill``; the asserted exit is ``-SIGKILL``) after
     at least one checkpoint landed;
  3. **resume** — the same command line plus ``--resume``: restores the
     newest checkpoint and runs to completion.

The gate: the resumed labels equal the reference's bit for bit, and the
resumed run did resume (``resumed_from`` > 0).

  python tools/torch_kill_resume_check.py --device cpu --scale 0.005 \
      --max-steps 20 --kill-at 9
  python tools/torch_kill_resume_check.py --device cuda --scale 0.01 \
      --max-steps 30 --kill-at 12 --checkpoint-every 4 --sync-every 4

``--chunk-schedule sharded|halo|async`` runs every phase on a mesh of
``--shards N`` shards, all on ``--device`` (the launcher's ``--shards``), at
an unchanged shard count; ``--halo-granularity`` and ``--staleness-bound``
are forwarded. The reference checkpoints too (into its own directory):
under the async schedule a checkpoint window forces a fresh exchange, so
the reference follows the victim's refresh policy at any staleness bound.

  python tools/torch_kill_resume_check.py --device cpu --scale 0.005 \
      --max-steps 20 --kill-at 9 --chunk-schedule async --staleness-bound 1 \
      --shards 4

``--resume-shards M`` resumes the victim's checkpoint on M shards instead
(the port's counterpart of `tools/kill_resume_check.py`'s
``--devices`` / ``--resume-devices`` legs). The sharded trajectory is
specific to the shard count, so across a count change the gate is
**transport exactness**: a run capped at the checkpoint's step on the
original count, and the checkpoint restored onto M shards with the same
cap (zero further supersteps), give the same labels bit for bit.
``--hub-replication`` / ``--hub-quantile`` are forwarded.

  python tools/torch_kill_resume_check.py --device cpu --scale 0.005 \
      --max-steps 20 --kill-at 9 --chunk-schedule halo --shards 8 \
      --resume-shards 4

Exit status 0 iff every assertion holds.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_launcher(extra, *, env_extra=None, check=True):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.pop("REPRO_FAULTS", None)
    if env_extra:
        env.update(env_extra)
    cmd = [sys.executable, "-m", "repro_torch.launch.partition", "--json"] + extra
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if check and proc.returncode != 0:
        sys.stderr.write(proc.stdout + proc.stderr)
        raise SystemExit(f"launcher failed ({proc.returncode}): {cmd}")
    return proc


def load_labels(path, algo):
    with np.load(path) as z:
        return z[algo].copy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cpu or cuda")
    ap.add_argument("--dataset", default="WIKI")
    ap.add_argument("--scale", type=float, default=0.01)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--algo", default="revolver")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-steps", type=int, default=30)
    ap.add_argument("--sync-every", type=int, default=4)
    ap.add_argument("--checkpoint-every", type=int, default=4)
    ap.add_argument("--kill-at", type=int, default=14,
                    help="superstep at which the victim run SIGKILLs itself")
    ap.add_argument("--chunk-schedule", default="sequential",
                    choices=["sequential", "sharded", "halo", "async"])
    ap.add_argument("--shards", type=int, default=4,
                    help="shards of the sharded schedules, all on --device")
    ap.add_argument("--halo-granularity", default="auto",
                    choices=["auto", "block", "vertex"])
    ap.add_argument("--staleness-bound", type=int, default=0,
                    help="async schedule: forwarded to the launcher")
    ap.add_argument("--resume-shards", type=int, default=None,
                    help="resume on this many shards (elastic restore; default "
                         "--shards)")
    ap.add_argument("--hub-replication", action="store_true",
                    help="forwarded to the launcher (halo/async schedules)")
    ap.add_argument("--hub-quantile", type=float, default=0.0,
                    help="forwarded to the launcher with --hub-replication")
    args = ap.parse_args(argv)
    if args.resume_shards is not None and args.chunk_schedule == "sequential":
        ap.error("--resume-shards needs a sharded --chunk-schedule")
    resume_shards = args.shards if args.resume_shards is None else args.resume_shards
    count_change = resume_shards != args.shards

    work = tempfile.mkdtemp(prefix="torch_kill_resume_")
    ckpt = os.path.join(work, "ckpt")
    base = ["--device", args.device, "--dataset", args.dataset,
            "--scale", str(args.scale), "--k", str(args.k), "--algo", args.algo,
            "--seed", str(args.seed), "--max-steps", str(args.max_steps),
            "--sync-every", str(args.sync_every),
            "--chunk-schedule", args.chunk_schedule]
    if args.chunk_schedule != "sequential":
        base += ["--shards", str(args.shards)]
    if args.chunk_schedule in ("halo", "async"):
        base += ["--halo-granularity", args.halo_granularity]
    if args.chunk_schedule == "async":
        base += ["--staleness-bound", str(args.staleness_bound)]
    if args.hub_replication:
        base += ["--hub-replication", "--hub-quantile", str(args.hub_quantile)]
    try:
        ref = None
        if not count_change:
            # 1. reference (uninterrupted; checkpointed like the victim, into
            # a directory of its own, so both refresh the async exchange
            # alike)
            ref_path = os.path.join(work, "ref.npz")
            run_launcher(base + ["--labels-out", ref_path,
                                 "--checkpoint-dir", os.path.join(work, "ref_ckpt"),
                                 "--checkpoint-every", str(args.checkpoint_every)])
            ref = load_labels(ref_path, args.algo)
            print(f"reference: n={ref.size} labels")

        # 2. victim: checkpointing on, killed mid-run by the fault plan
        ckpt_args = base + ["--checkpoint-dir", ckpt,
                            "--checkpoint-every", str(args.checkpoint_every)]
        victim = run_launcher(
            ckpt_args, env_extra={"REPRO_FAULTS": f"kill@superstep={args.kill_at}"},
            check=False)
        if victim.returncode != -signal.SIGKILL:
            print(f"FAIL: victim exited {victim.returncode}, expected "
                  f"{-signal.SIGKILL} (SIGKILL)")
            sys.stderr.write(victim.stdout + victim.stderr)
            return 1
        algo_ckpt = os.path.join(ckpt, args.algo)
        saved = [int(d.split("_")[1]) for d in os.listdir(algo_ckpt)
                 if d.startswith("step_") and not d.endswith(".tmp")]
        if not saved:
            print("FAIL: victim left no checkpoint before dying")
            return 1
        saved_step = max(saved)
        print(f"victim: SIGKILLed at superstep {args.kill_at}, newest "
              f"checkpoint at step {saved_step}")

        if count_change:
            # 3. transport exactness: the labels of a run capped at the
            # checkpoint's step on the original count, against the
            # checkpoint restored onto the new count with the same cap
            def capped(shards):
                out = base[:]
                out[out.index("--max-steps") + 1] = str(saved_step)
                out[out.index("--shards") + 1] = str(shards)
                return out

            cap_ref = os.path.join(work, "cap_ref.npz")
            run_launcher(capped(args.shards) + [
                "--labels-out", cap_ref, "--checkpoint-dir", os.path.join(work, "ref_ckpt"),
                "--checkpoint-every", str(args.checkpoint_every)])
            cap_out = os.path.join(work, "cap_resumed.npz")
            proc = run_launcher(capped(resume_shards) + [
                "--checkpoint-dir", ckpt, "--checkpoint-every", str(args.checkpoint_every),
                "--resume", "--labels-out", cap_out])
            rows = json.loads(proc.stdout.splitlines()[-1])
            if rows[0].get("resumed_from") != saved_step:
                print(f"FAIL: resume phase restored {rows[0].get('resumed_from')}, "
                      f"expected step {saved_step}")
                return 1
            a, b = load_labels(cap_ref, args.algo), load_labels(cap_out, args.algo)
            ok = bool(np.array_equal(a, b))
            print(f"elastic transport ({args.shards}->{resume_shards} shards, capped at "
                  f"step {saved_step}, device {args.device}, schedule "
                  f"{args.chunk_schedule}): exact={ok}"
                  + ("" if ok else f" ({int((a != b).sum())} differ)"))
            print("PASS" if ok else "FAIL")
            return 0 if ok else 1

        # 3. resume to completion; must equal the reference exactly
        out = os.path.join(work, "resumed.npz")
        proc = run_launcher(ckpt_args + ["--resume", "--labels-out", out])
        rows = json.loads(proc.stdout.splitlines()[-1])
        if not rows[0].get("resumed_from"):
            print("FAIL: resume phase did not restore a checkpoint")
            return 1
        resumed = load_labels(out, args.algo)
        ok = bool(np.array_equal(ref, resumed))
        diff = 0 if ok else int((ref != resumed).sum())
        print(f"resume (from step {rows[0]['resumed_from']}, device "
              f"{args.device}, schedule {args.chunk_schedule}): bit-identical={ok}"
              + ("" if ok else f" ({diff} differ)"))
        print("PASS" if ok else "FAIL")
        return 0 if ok else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
