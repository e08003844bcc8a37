"""The correctness plane on the device collectives: the runtime
sanitizer's cost on coll/cuda's Allreduce and on the ZeRO step, a seeded
collective mismatch caught at the call, the leak report and the
memchecker.

Run under the launcher with the sanitizer at level 2 from Init (the
instance brings it up last; ``check_level`` or ``OMPI_TPU_CHECK``) and
the telemetry plane's watchdog armed with a long hang timeout::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on --mca check_level 2 --mca telemetry_enable 1 \\
        --mca telemetry_hang_timeout 600 --mca telemetry_dump_dir DIR \\
        ompi_tpu_torch/examples/correctness.py --device --out DIR

``--device`` is the example's one form: every buffer of parts A and B is
a tensor on the rank's device (the card). Add ``--mca
device_plane_platform cpu`` and ``--tiny`` on a machine without a GPU.

Part A (the cost): the device ``Allreduce`` (SUM, float32) at each size
of ``--sizes`` (1 KiB, 1 MiB and 256 MiB a rank) under coll/cuda's
``'linear'`` (K3) and ``'ring'`` (K1 + K2), at sanitizer levels 0, 1
and 2 in turns (``sanitizer.disable`` / ``enable`` in the job; the level
order rotates each round), ``--rounds`` rounds of ``--calls`` calls each,
each call timed to a device synchronise; every result bitwise equal to
its mode's plain fold. Then the ZeRO stage-2 ``'linear'`` step at
GPT-2 small's full width (``zero_training.py``'s parameters, lr and
momentum): one optimizer stepped at level 0 and one at level 2 on the
same parameters and gradients, two steps each in turns; the parameters
and momentum shards bitwise equal across the levels. Also the host cost
of level 1's argument check per call (``Sanitizer.pre_call`` on the
Allreduce's arguments).

Part B (the seeded mismatch): with the sanitizer live at level 2, every
rank calls ``comm.Allreduce(torch.ones(rank + 1, device=dev))``: every
rank raises the named ``MPIError`` ("signature mismatch" at
``Allreduce``, the seq, this rank and the peer it compared with) before
any kernel launches; the matched ``'linear'`` Allreduce after it is
bitwise its fold. The telemetry plane's watchdog writes no hang dump.

Part C (the memchecker, then level 1's leak report): with the sanitizer
down, under ``memchecker on``, each even rank posts an ``Irecv`` into a
host buffer and sends from it: ob1 raises ``MemcheckError`` (the send
request it had made is abandoned, never completed: the registry would
count it); then it posts an ``Irecv`` into a tensor and sends from that
tensor: not flagged (device buffers have no shadow, as in the JAX
package). Then at level 1 a ``Send_init`` never freed: the Finalize hook
reports it, ``check_leaks`` 1 on every rank.

With ``--out DIR`` each rank writes ``DIR/rank<r>.json`` after Finalize:
the cases, its K1-K3 launches of parts A and B against what the
schedules imply, and (rank 0) the report: the p50 per (size, mode,
level), the ZeRO step times, the pre-call ns, B's messages.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch import check, errors, mpi
from ompi_tpu_torch.check import memchecker, sanitizer
from ompi_tpu_torch.core import cvar, pvar
from ompi_tpu_torch.examples import kernel_counts as KC
from ompi_tpu_torch.examples import zero_training as zt
from ompi_tpu_torch.examples.device_collectives import (_sizes,
                                                        expected_allreduce,
                                                        make_input)
from ompi_tpu_torch.runtime import device_plane
from ompi_tpu_torch.zero import ZeroOptimizer, layout as zl

MODES = ("linear", "ring")
LEVELS = (0, 1, 2)
#: calls the level-1 argument check is timed over
PRECALL_CALLS = 20_000
#: the comms' signature sequence numbers carried across sanitizer
#: instances: a re-enabled sanitizer starts where the last one stopped,
#: so no (comm, seq) store key is published twice in a job
_SEQ: dict = {}


def set_level(level: int, rank: int) -> None:
    """The sanitizer at ``level`` (0: down), as ``check_level`` would
    bring it up."""
    san = sanitizer.SANITIZER
    if san is not None:
        _SEQ.update(san._seq)
        sanitizer.disable()
    if level:
        sanitizer.enable(rank=rank, level=level)
        sanitizer.SANITIZER._seq.update(_SEQ)


def part_a(comm, ns, dev, case, report) -> dict:
    """The device Allreduce and the ZeRO step at each level, in turns;
    returns the K1-K3 launches the schedules imply."""
    n, r = comm.size, comm.rank
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    sizes = _sizes(ns.sizes)
    mine, want = {}, {}
    for nb in sizes:
        xs = [make_input(ns.seed, p, nb // 4, torch.float32, dev)
              for p in range(n)]
        mine[nb] = xs[r]
        for mode in MODES:
            want[nb, mode] = expected_allreduce(xs, "MPI_SUM", mode, n)
        del xs
    times = {f"{nb}_{mode}_l{lv}": [] for nb in sizes for mode in MODES
             for lv in LEVELS}
    same = {key: True for key in times}
    for nb in sizes:  # warm-up at the init level: maps every arena
        for mode in MODES:
            comm.Allreduce(mine[nb], deterministic=mode)
    sync()
    for rnd in range(ns.rounds):
        for lv in LEVELS[rnd % 3:] + LEVELS[:rnd % 3]:
            set_level(lv, r)
            for nb in sizes:
                for mode in MODES:
                    key = f"{nb}_{mode}_l{lv}"
                    for _ in range(ns.calls):
                        sync()
                        t0 = time.perf_counter()
                        out = comm.Allreduce(mine[nb], deterministic=mode)
                        sync()
                        times[key].append((time.perf_counter() - t0) * 1e3)
                        same[key] = same[key] and zt.bits_equal(
                            out, want[nb, mode])
    for key, ok in same.items():
        case(f"Allreduce {key}: bitwise its mode's fold", ok)
    calls = 1 + ns.rounds * ns.calls * len(LEVELS)
    derived = KC.merged(*[KC.add({}, K3=calls) if mode == "linear"
                          else {k: v * calls for k, v in
                                KC.ring_allreduce(n).items()}
                          for _nb in sizes for mode in MODES])
    del want

    # the ZeRO stage-2 'linear' step: one optimizer per level
    set_level(2, r)
    spec = zt.gpt2_spec(zt.TINY if ns.tiny else zt.GPT2, ns.layers)
    shapes = zl.tree_leaves(spec)
    treedef = zl.tree_flatten(spec)[1]
    params = zt.make_tree(spec, dev, 0.02, ns.seed, 0)
    opts = {lv: ZeroOptimizer(comm, params, lr=zt.LR, momentum=zt.MOMENTUM,
                              stage=2, deterministic="linear")
            for lv in (0, 2)}
    step_ms = {lv: [] for lv in opts}
    outs = {}
    for step in range(ns.zero_steps):
        grads = zl.tree_unflatten(treedef, [
            zt.grad_leaf(shapes, dev, ns.seed, r, step, i)
            for i in range(len(shapes))])
        for lv in ((0, 2) if step % 2 == 0 else (2, 0)):
            set_level(lv, r)
            comm.Barrier()
            sync()
            t0 = time.perf_counter()
            outs[lv] = opts[lv].step(grads)
            sync()
            step_ms[lv].append((time.perf_counter() - t0) * 1e3)
        del grads
    nbk = len(opts[0].state.params.plan.buckets)
    a, b = zl.tree_leaves(outs[0]), zl.tree_leaves(outs[2])
    case("ZeRO step: parameters bitwise equal at levels 0 and 2",
         len(a) == len(b) and all(zt.bits_equal(p, q) for p, q in zip(a, b)))
    ma = opts[0].state.slots["momentum"].shards
    mb = opts[2].state.slots["momentum"].shards
    case("ZeRO step: momentum shards bitwise equal at levels 0 and 2",
         len(ma) == len(mb) and all(zt.bits_equal(p, q)
                                    for p, q in zip(ma, mb)))
    steps = 2 * ns.zero_steps
    derived = KC.merged(derived, KC.add({}, K3=steps * nbk,
                                        K2=steps * nbk * n if n > 1 else 0))
    for opt in opts.values():
        opt.free()
    del params, outs, a, b, ma, mb

    # level 1's argument check on the host, per call
    set_level(1, r)
    san = sanitizer.SANITIZER
    x = mine[sizes[0]]
    t0 = time.perf_counter_ns()
    for _ in range(PRECALL_CALLS):
        san.pre_call("Allreduce", comm, (x,), {"deterministic": "linear"})
    report["precall_l1_ns"] = (time.perf_counter_ns() - t0) / PRECALL_CALLS

    def p50(v):
        return sorted(v)[len(v) // 2]

    report["sizes"] = sizes
    report["p50_ms"] = {k: p50(v) for k, v in times.items()}
    report["spread_ms"] = {k: [min(v), max(v)] for k, v in times.items()}
    report["zero_step_ms"] = {f"l{lv}": v for lv, v in step_ms.items()}
    report["zero_buckets"] = nbk
    report["zero_parameters"] = sum(
        int(np.prod(s)) for s in shapes)
    return derived


def part_b(comm, ns, dev, case, report) -> dict:
    """The seeded mismatch at level 2, then a matched Allreduce."""
    n, r = comm.size, comm.rank
    set_level(2, r)
    san = check.get_sanitizer()
    case("sanitizer live at level 2 before the mismatch",
         san is not None and san.level == 2)
    msg, mm = "", None
    try:
        comm.Allreduce(torch.ones(r + 1, device=dev))
    except errors.MPIError as exc:
        msg = str(exc)
        mm = san.last_mismatch
    ok = mm is not None and "signature mismatch" in msg \
        and "Allreduce" in msg and f"seq {mm['seq']}" in msg \
        and f"rank {r}" in msg and f"rank {mm['peer']}" in msg \
        and mm["peer"] != r
    case("the rank-dependent count raised the named MPIError", ok,
         message=msg)
    xs = [make_input(ns.seed + 1, p, 1 << 10, torch.float32, dev)
          for p in range(n)]
    out = comm.Allreduce(xs[r], deterministic="linear")
    case("the matched Allreduce after it: bitwise the linear fold",
         zt.bits_equal(out, expected_allreduce(xs, "MPI_SUM", "linear", n)))
    report["mismatch"] = msg
    return KC.add({}, K3=1)


def part_c(comm, ns, dev, case, report):
    """memchecker on host and device buffers; returns the leak left for
    Finalize (held by the caller: the registry's weak reference forgets
    a request nobody holds)."""
    n, r = comm.size, comm.rank
    set_level(0, r)
    cvar.set("memchecker", "on")
    partner = r ^ 1
    v0 = pvar.read("memchecker_violations")
    if partner < n:
        host = np.zeros(64, np.float32)
        t = torch.zeros(64, device=dev)
        if r % 2 == 0:
            req = comm.Irecv(host, source=partner, tag=7)
            try:
                comm.Send(host, partner, tag=9)
                flagged = ""
            except memchecker.MemcheckError as exc:
                flagged = str(exc)
            comm.Send(np.ones(64, np.float32), partner, tag=9)
            req.wait()
            case("a send from a pending host receive buffer: "
                 "MemcheckError", "pending" in flagged, message=flagged)
            case("the host receive landed", bool((host == 5.0).all()))
            treq = comm.Irecv(t, source=partner, tag=17)
            comm.Send(t, partner, tag=19)  # not flagged: no shadow
            treq.wait()
            case("a tensor receive buffer is not flagged",
                 pvar.read("memchecker_violations") - v0 == 1
                 and bool((t == 7.0).all()))
        else:
            got = np.zeros(64, np.float32)
            comm.Recv(got, partner, tag=9)
            comm.Send(np.full(64, 5.0, np.float32), partner, tag=7)
            comm.Recv(t, partner, tag=19)
            comm.Send(torch.full((64,), 7.0, device=dev), partner, tag=17)
            case("no violation on the odd rank",
                 pvar.read("memchecker_violations") == v0)
    cvar.set("memchecker", "off")
    report["memchecker_violations"] = pvar.read("memchecker_violations") \
        - v0
    # the leak: a persistent send never started, never freed
    set_level(1, r)
    return comm.Send_init(np.zeros(4, np.float32), (r + 1) % n, tag=5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", action="store_true",
                    help="tensors on the rank's device (required: the "
                         "example's one form)")
    ap.add_argument("--sizes", default="1k,1m,256m",
                    help="Allreduce payloads a rank (float32)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--calls", type=int, default=11,
                    help="timed calls per (size, mode, level) a round")
    ap.add_argument("--layers", type=int, default=zt.GPT2["n_layer"])
    ap.add_argument("--zero-steps", type=int, default=2,
                    help="steps of each ZeRO optimizer, in turns")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    if not ns.device:
        ap.error("pass --device: the example runs on device buffers")
    if ns.tiny:
        ns.sizes, ns.rounds, ns.calls, ns.layers = "1k,64k", 1, 3, 2
    comm = mpi.Init()
    n, r = comm.size, comm.rank
    dev = device_plane.device()
    cases, report = [], {}

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[correctness n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    san = check.get_sanitizer()
    case("the sanitizer up at init at check_level 2",
         san is not None and san.level == 2 and check.level() == 2)
    counts = KC.Counts(dev)
    counts.reset()
    derived = KC.merged(part_a(comm, ns, dev, case, report),
                        part_b(comm, ns, dev, case, report))
    launched = counts.read()
    case("K1-K3 launches == derived from the schedules",
         launched == {k: derived.get(k, 0) for k in launched},
         got=launched, want=derived)
    leak = part_c(comm, ns, dev, case, report)  # check: disable=unwaited-request; the leak C reports
    staged = pvar.read("coll_accelerator_staged")
    leaks0 = pvar.read("check_leaks")
    mpi.Finalize()
    report["leaks"] = pvar.read("check_leaks") - leaks0
    del leak
    cases.append({"name": "the Send_init never freed: one leak at Finalize",
                  "ok": report["leaks"] == 1, "leaks": report["leaks"]})
    if r == 0:
        print(f"[correctness n={n}] {json.dumps(report)}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "launches": launched, "expected_launches": derived,
                       "required": [k for k, v in derived.items() if v],
                       "report": report, "cases": cases,
                       "coll_accelerator_staged": staged}, f)
    bad = [c for c in cases if not c["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
