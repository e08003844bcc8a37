"""The tools plane on the device paths: MPI_T events, PERUSE, pml/v
message logging, indexed matching and MPI_T cvar handles.

Run under the launcher, one rank per process::

    python -m ompi_tpu_torch.runtime.launcher -n 4 --mca device_plane on \\
        --mca coll_cuda on --mca pml_v 1 --mca pml_ob1_matching indexed \\
        --mca pml_accel_chunk_bytes 262144 \\
        ompi_tpu_torch/examples/tools_plane.py

Every rank allocates its ``btl_endpoint_connected`` handle before Init;
then, on the rank's device:

1. **Wireup**: the sm transport's event fired once per peer.
2. **Device ring** (``--ring-bytes``, 1 MiB, float32 then bfloat16 drawn
   from seeded generators): each rank ``Isend``s its tensor to its right
   neighbour and ``Recv``s its left neighbour's through
   ``pml/accel_p2p``'s staging under pml/v and indexed matching, with
   every MPI_T event type and PERUSE event listened to. Each received
   tensor must equal the left neighbour's bitwise; the
   ``pml_message_matched`` and PERUSE ``REQ_COMPLETE`` instances of the
   ring's messages must number, per tensor, one header and the chunks
   ``pml_accel_chunk_bytes`` cuts it into; pml/v's log of the sends,
   reassembled, must be the tensor's bytes, and ``resend`` into fresh
   device tensors must give the same bits.
3. **MPI_T cvar handle**: a float32 Allreduce of 4 MiB (integer values,
   so every fold order is exact) under coll/cuda takes the
   bidirectional ring; a ``CvarHandle`` write of
   ``coll_cuda_bidir_min_bytes`` (-1) moves the next one's bytes from
   ``coll_cuda_bidir_bytes`` to ``coll_cuda_ring_bytes``, bitwise the
   same result; the handle then writes the old value back.
4. **Device-epoch fallback**: a ``DeviceEpochWindow`` BAND Accumulate
   raises ERR_OP and emits ``osc_device_fallback`` once with the
   reference's (op, reason).
5. **CudaWindow epochs**: a fence epoch on a float32 window of
   ``--window`` elements (each rank Puts 2**20 elements to its right
   neighbour, K7, and 4096 more, K8's batch, and ``Get_epoch``s 4096
   from its left, K9's and K10's batches); then, on an int32 window, a
   Lock epoch with a Put, a PSCW epoch with a Put, and a Lock epoch with
   a BAND Accumulate (host-assisted: a K9 read and a K7 replace at the
   target), which emits ``osc_cuda_fallthrough``. The windows must hold
   what a plain recomputation gives, every epoch must emit its
   ``osc_epoch_transition`` enter and exit, and the K7-K10 launches
   (zeroed before this part, read after part 6) must equal what the rank
   derives from every rank's schedule (the reference's rounds cut into
   exchanges, as ``device_epoch.py`` derives them, and one K7 / K9 per
   AM-plane op served).
6. **Costs**: the device ring (float32) and the fence epoch, timed in
   turns with no handle and with a handle on every event type and every
   PERUSE event (``--reps``, 9, samples each, rank 0's host clock with the
   card synchronised on both sides); and a guard with no listener
   (``events.active(name)``, ``peruse.active``), ns a check on the host
   (a loop of the check less a loop of a call that does nothing).

With ``--out DIR`` each rank writes ``DIR/rank<r>.json``. ``--tiny`` runs
a 64 KiB ring, a 16384-element window and 1024-element blocks (the CPU
rehearsal under ``--mca device_plane_platform cpu``; there the wrappers
take their plain versions and count nothing, so the launch counts are
checked on the card only).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ompi_tpu_torch.core import events

RING_TAG = 31
BIG = 1 << 20  # the fence epoch's contiguous put (K7 from 2**20 elements)
SMALL = 4096   # its second put (K8's batch) and its Get_epoch
AM_PUT = 16    # the int32 window's puts
GUARD_CALLS = 200_000  # guard checks timed a loop


def _gen(device, *key) -> torch.Generator:
    seed = 0
    for k in key:
        seed = (seed * 1_000_003 + int(k)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(seed)


def ring_tensor(seed, q, dtype, nbytes, dev) -> torch.Tensor:
    """Rank q's ring tensor of ``dtype``."""
    n = nbytes // torch.empty(0, dtype=dtype).element_size()
    return torch.randn(n, generator=_gen(dev, seed, q, n),
                       device=dev).to(dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ring-bytes", type=int, default=1 << 20)
    ap.add_argument("--window", type=int, default=1 << 21,
                    help="float32 elements of the fence epoch's window")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default="")
    ns = ap.parse_args(argv)
    big, small = BIG, SMALL
    if ns.tiny:
        ns.ring_bytes, ns.window, big, small = 1 << 16, 1 << 14, 4096, 1024

    # the wireup fires inside Init: its handle comes first
    wired = []
    h_btl = events.handle_alloc("btl_endpoint_connected", callback=lambda e:
                                wired.append((e.data["btl"],
                                              e.data["peer"])))
    from ompi_tpu_torch import compat, errors, mpi, mpit, op as op_mod, osc
    from ompi_tpu_torch.core import pvar
    from ompi_tpu_torch.examples.device_epoch import (bits_equal,
                                                      derived_launches,
                                                      reference_rounds)
    from ompi_tpu_torch.osc import cuda_kernels as O
    from ompi_tpu_torch.osc.cuda import CudaWindow
    from ompi_tpu_torch.pml import accel_p2p, peruse, vprotocol
    from ompi_tpu_torch.runtime import device_plane

    comm = mpi.Init()
    n, r = comm.size, comm.rank
    assert n >= 2, "the example needs 2 ranks or more"
    h_btl.free()
    dev = device_plane.device()
    cuda = dev.type == "cuda"
    left, right = (r - 1) % n, (r + 1) % n
    s = pvar.session()
    cases, report = [], {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def case(name, ok, **info):
        cases.append({"name": name, "ok": bool(ok), **info})
        if r == 0:
            print(f"[tools_plane n={n}] {name}: "
                  f"{'ok' if ok else 'MISMATCH'} {info or ''}", flush=True)

    def listen(counts):
        """A counting callback on every event type and PERUSE event;
        returns what :func:`unlisten` frees."""
        hs = [events.handle_alloc(i, callback=lambda e: counts.append(
            (e.type_name, e.data.get("ctx"), e.data.get("tag"))))
            for i in range(events.get_num())]

        def cb(e):
            counts.append((e["event"], e["ctx"], e["tag"]))
        for ev in peruse.EVENTS:
            peruse.subscribe(ev, cb)
        return hs, cb

    def unlisten(state):
        hs, cb = state
        for h in hs:
            h.free()
        for ev in peruse.EVENTS:
            peruse.unsubscribe(ev, cb)

    # -- 1. wireup ------------------------------------------------------------
    case("btl_endpoint_connected once per peer, over sm",
         sorted(wired) == [("sm", p) for p in range(n) if p != r],
         wired=sorted(wired))

    # -- 2. the device ring ---------------------------------------------------
    v = vprotocol.installed()
    case("pml/v installed, indexed matching",
         v is not None and mpit.CvarHandle(
             mpit.cvar_index("pml_ob1_matching")).read() == "indexed")
    c = comm.dup()
    right_world = c.group.ranks[right]
    dtypes = (torch.float32, torch.bfloat16)
    sent = [ring_tensor(ns.seed, r, dt, ns.ring_bytes, dev) for dt in dtypes]
    want = [ring_tensor(ns.seed, left, dt, ns.ring_bytes, dev)
            for dt in dtypes]
    seen: list = []
    state = listen(seen)
    ok_ring, counts, logs = True, [], []
    for x, w in zip(sent, want):
        nchunks = -(-ns.ring_bytes // accel_p2p._chunk_bytes(
            x.element_size()))
        m0 = len(seen)
        y = torch.empty_like(x)
        sreq = c.Isend(x, right, RING_TAG)
        c.Recv(y, left, RING_TAG)
        sreq.wait()
        sync()
        ok_ring &= bits_equal(y.view(-1), w) if x.dtype == torch.float32 \
            else torch.equal(y.view(torch.int16), w.view(torch.int16))
        mine = [e for e in seen[m0:] if e[1] == c.cid * 2
                and e[2] == RING_TAG]
        counts.append({
            "nchunks": nchunks,
            "matched": sum(e[0] == "pml_message_matched" for e in mine),
            "complete": sum(e[0] == peruse.REQ_COMPLETE for e in mine)})
        entries = [e for e in v.send_log[right_world] if e[1] == c.cid]
        entries = entries[-(1 + nchunks):]
        hdr = np.frombuffer(entries[0][3][0], np.int64)
        body = b"".join(e[3][0] for e in entries[1:])
        logs.append(int(hdr[0]) == x.numel() and
                    body == compat.tensor_to_numpy(x).tobytes())
    unlisten(state)
    case(f"device ring float32 and bfloat16 ({ns.ring_bytes} B) bitwise",
         ok_ring)
    case("pml_message_matched and REQ_COMPLETE per tensor == 1 header + "
         "its chunks", all(k["matched"] == k["complete"] == 1 + k["nchunks"]
                           for k in counts), counts=counts)
    case("pml/v's log, reassembled, == each sent tensor's bytes", all(logs))
    # the replay: every rank re-sends its log for its right neighbour on c
    # into fresh device tensors its neighbour posted first
    c.Barrier()
    fresh = [torch.empty_like(x) for x in sent]
    reqs = [c.Irecv(f, left, RING_TAG) for f in fresh]
    resent = v.resend(right_world, c)
    for q in reqs:
        q.wait()
    sync()
    case("resend into fresh device tensors gives the same bits",
         all(torch.equal(a.view(-1).view(torch.uint8),
                         b.view(torch.uint8))
             for a, b in zip(fresh, want))
         and resent == sum(1 + k["nchunks"] for k in counts),
         resent=resent)
    v.truncate(right_world)
    c.Barrier()

    # -- 3. an MPI_T cvar handle steers coll/cuda --------------------------
    h = mpit.CvarHandle(mpit.cvar_index("coll_cuda_bidir_min_bytes"))
    old = h.read()
    xa = torch.randint(-8, 8, (1 << 20,), generator=_gen(dev, ns.seed, 9, r),
                       device=dev).to(torch.float32)
    moved = {}
    outs = []
    for val in (old, -1):
        h.write(val)
        b0 = s.read("coll_cuda_bidir_bytes")
        g0 = s.read("coll_cuda_ring_bytes")
        outs.append(comm.Allreduce(xa))
        moved[str(val)] = [s.read("coll_cuda_bidir_bytes") - b0,
                           s.read("coll_cuda_ring_bytes") - g0]
    h.write(old)
    sync()
    case("CvarHandle write of coll_cuda_bidir_min_bytes moves the Allreduce "
         "from the bidirectional ring to the ring, bitwise the same",
         moved[str(old)][0] > 0 and moved[str(old)][1] == 0
         and moved["-1"][0] == 0 and moved["-1"][1] > 0
         and bits_equal(outs[0], outs[1]) and h.read() == old, moved=moved)

    # -- 4. the device-epoch window's fallback --------------------------------
    fb = []
    hf = events.handle_alloc("osc_device_fallback", callback=lambda e:
                             fb.append([e.data["op"], e.data["reason"]]))
    dw = osc.win_create_device(comm, torch.zeros(64, dtype=torch.int32,
                                                 device=dev))
    dw.Fence()
    try:
        dw.Accumulate(torch.ones(4, dtype=torch.int32, device=dev), right, 0,
                      op_mod.BAND)
        raised = None
    except errors.MPIError as e:
        raised = e.error_class
    dw.Fence()
    dw.Free()
    hf.free()
    case("DeviceEpochWindow BAND: ERR_OP and osc_device_fallback once",
         raised == errors.ERR_OP and fb == [[
             "accumulate",
             "op 'MPI_BAND' is not fusable into the fence program"]], fb=fb)

    # -- 5. CudaWindow epochs -------------------------------------------------
    size = ns.window
    base = torch.randn(size, generator=_gen(dev, ns.seed, 5, r), device=dev)
    wf = osc.win_create(comm, base, disp_unit=4)
    wi = osc.win_create(comm, torch.zeros(64, dtype=torch.int32, device=dev),
                        disp_unit=4)
    case("both windows are CudaWindows",
         isinstance(wf, CudaWindow) and isinstance(wi, CudaWindow))
    blk = torch.randn(big, generator=_gen(dev, ns.seed, 6, r), device=dev)
    blk2 = torch.randn(small, generator=_gen(dev, ns.seed, 7, r), device=dev)
    puts = [(q, (q + 1) % n, 0, big, "put") for q in range(n)] \
        + [(q, (q + 1) % n, big, small, "put") for q in range(n)]
    gets = [((q - 1) % n, q, big + 2 * small, small) for q in range(n)]
    per_epoch = derived_launches(reference_rounds(puts),
                                 reference_rounds(gets), r, n, size, 4)
    wanted = {k: 0 for k in ("rma_apply", "rma_apply_strided",
                             "rma_apply_strided_batch", "rma_read",
                             "rma_read_batch", "rma_permute_recv_batch")}
    epochs: list = []
    he = events.handle_alloc("osc_epoch_transition", callback=lambda e:
                             epochs.append([e.data["kind"], e.data["phase"]]))
    ft = []
    hft = events.handle_alloc("osc_cuda_fallthrough", callback=lambda e:
                              ft.append([e.data["what"], e.data["reason"]]))
    O.reset_launches()

    def fence_epoch():
        """The opening Fence, the epoch's ops, the closing Fence; returns
        the Get's handle and the epoch's ms."""
        wf.Fence()
        sync()
        t0 = time.perf_counter()
        wf.Put(blk, right, disp=0)
        wf.Put(blk2, right, disp=big)
        g = wf.Get_epoch(small, left, disp=big + 2 * small)
        wf.Fence()
        sync()
        for k, val in per_epoch.items():
            wanted[k] += val
        return g, (time.perf_counter() - t0) * 1e3

    g, _ = fence_epoch()
    lblk = torch.randn(big, generator=_gen(dev, ns.seed, 6, left), device=dev)
    lblk2 = torch.randn(small, generator=_gen(dev, ns.seed, 7, left),
                        device=dev)
    lbase = torch.randn(size, generator=_gen(dev, ns.seed, 5, left),
                        device=dev)
    want_win = base.clone()
    want_win[:big] = lblk
    want_win[big:big + small] = lblk2
    case("fence epoch: the window and the Get == a plain recomputation",
         bits_equal(wf.array, want_win)
         and bits_equal(g.array, lbase[big + 2 * small:big + 3 * small]))
    # the AM plane on the int32 window, every rank targeting its right
    # neighbour: Lock + Put, PSCW + Put, Lock + BAND (host-assisted)
    one = torch.full((AM_PUT,), 5, dtype=torch.int32, device=dev)
    wi.Lock(right)
    wi.Put(one, right, disp=0)
    wi.Unlock(right)
    comm.Barrier()
    wi.Post([left])
    wi.Start([right])
    wi.Put(one + 1, right, disp=AM_PUT)
    wi.Complete()
    wi.Wait()
    comm.Barrier()
    wi.Lock(right)
    wi.Accumulate(torch.full((AM_PUT,), 3, dtype=torch.int32, device=dev),
                  right, disp=AM_PUT, op=op_mod.BAND)
    wi.Unlock(right)
    comm.Barrier()
    wi.Sync()
    # served at this rank from its left neighbour: three K7 (two puts and
    # the BAND's replace) and one K9 (the BAND's read)
    wanted["rma_apply"] += 3
    wanted["rma_read"] += 1
    got_i = wi.array.cpu()
    case("int32 window: the Lock put, the PSCW put and the BAND fold "
         "landed", got_i[:AM_PUT].eq(5).all().item()
         and got_i[AM_PUT:2 * AM_PUT].eq(6 & 3).all().item()
         and got_i[2 * AM_PUT:].eq(0).all().item())
    case("osc_cuda_fallthrough: the host-assisted BAND, once", ft == [[
        "accumulate", "op 'MPI_BAND' is not elementwise"]], ft=ft)
    want_epochs = [["fence", "enter"], ["fence", "exit"]] * 2 + [
        ["lock", "enter"], ["lock", "exit"], ["pscw_exposure", "enter"],
        ["pscw_access", "enter"], ["pscw_access", "exit"],
        ["pscw_exposure", "exit"], ["lock", "enter"], ["lock", "exit"]]
    case("every epoch emits its osc_epoch_transition enter and exit",
         epochs == want_epochs, epochs=epochs)
    hft.free()
    he.free()

    # -- 6. costs: no handle vs every handle, in turns ------------------------
    x = sent[0]
    y = torch.empty_like(x)
    times = {"ring": {"off": [], "on": []}, "fence": {"off": [], "on": []}}
    for k in range(2 * ns.reps):
        mode = ("off", "on")[(k + k // 2) % 2]  # off on on off off on ...
        state = listen([]) if mode == "on" else None
        comm.Barrier()
        sync()
        t0 = time.perf_counter()
        sreq = c.Isend(x, right, RING_TAG)
        c.Recv(y, left, RING_TAG)
        sreq.wait()
        sync()
        times["ring"][mode].append((time.perf_counter() - t0) * 1e3)
        _, ms = fence_epoch()
        times["fence"][mode].append(ms)
        if state is not None:
            unlisten(state)
    v.truncate(right_world)
    # a site with no listener: one guard, timed on this rank's host
    guard_ns = {}

    def nop():
        return None
    for name, check in (("events.active", lambda: events.active(
            "pml_message_matched")), ("peruse.active",
                                      lambda: peruse.active)):
        t0 = time.perf_counter_ns()
        for _ in range(GUARD_CALLS):
            check()
        base = time.perf_counter_ns()
        for _ in range(GUARD_CALLS):
            nop()
        guard_ns[name] = ((base - t0) - (time.perf_counter_ns() - base)) \
            / GUARD_CALLS
    got = {k: getattr(O, k).launches for k in wanted}
    case("K7-K10 launches == derived from the schedules", not cuda
         or got == wanted, got=got, want=wanted)
    wf.Free()
    wi.Free()

    def p50(xs):
        return sorted(xs)[len(xs) // 2]

    report["ring_bytes"] = ns.ring_bytes
    report["times_ms"] = times
    report["p50_ms"] = {part: {m: p50(t) for m, t in d.items()}
                        for part, d in times.items()}
    report["ring_counts"] = counts
    report["event_types"] = events.get_num()
    report["guard_ns"] = guard_ns
    pv = {k: s.read(k) for k in ("coll_accelerator_staged",
                                 "vprotocol_logged_sends",
                                 "vprotocol_resends")}
    if r == 0:
        print(f"[tools_plane n={n}] {json.dumps(report)}", flush=True)
    if ns.out:
        os.makedirs(ns.out, exist_ok=True)
        with open(os.path.join(ns.out, f"rank{r}.json"), "w") as f:
            json.dump({"rank": r, "size": n, "device": str(dev),
                       "launches": got, "expected_launches": wanted,
                       "required": [k for k, val in wanted.items() if val],
                       "report": report, "pvars": pv, "cases": cases,
                       "coll_accelerator_staged":
                           pv["coll_accelerator_staged"]}, f)
    bad = [cs for cs in cases if not cs["ok"]]
    assert not bad, f"rank {r}: failed checks: {bad}"
    mpi.Finalize()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
