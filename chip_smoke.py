"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port runs on
a GPU. Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. build the kernels with nvcc for sm_90a, one nvcc per source started
   side by side (into ``build/ompi_tpu_torch/``):
   ``ompi_tpu_torch/coll/csrc/ring_kernels.cu`` (K1-K5b),
   ``ompi_tpu_torch/coll/csrc/gemm_kernels.cu`` (K6) and
   ``ompi_tpu_torch/osc/csrc/rma_kernels.cu`` (K7-K10);
2. hold every kernel against its plain PyTorch version on the card:
   first K1 ring_rs_hop and K7 rma_apply, the kernels on the streaming
   engine (``ompi_tpu_torch/coll/csrc/stream.cuh``), for the three dtypes
   x every op with every output poisoned, at the paths' shapes and the
   engine's edges (tile boundaries, alignments; see
   :func:`engine_checks`); then K2 ring_ag_hop and K3 linear_fold for
   float32, bfloat16 and int32 x SUM/PROD/MIN/MAX at the collectives
   path's shape (a 256 MiB payload over 4 ranks) and at two ragged small
   shapes (one of them not 16-byte aligned), bitwise, inputs carrying NaN
   and +-0, and K2 also for float16, bool and uint8 (coll/device's pull
   schedule copies any dtype) at the 1 MiB block each pull copies on the
   ops path (a rank's whole payload) and at odd, unaligned lengths,
   outputs poisoned; K5 ring_rs_update_hop for the three dtypes with and
   without momentum and scaling at the training path's largest chunk (the
   bucket that holds GPT-2's ln_f, wpe and wte: 9,846,336 elements per
   rank over 4 ranks)
   and the ragged shapes, bitwise; K5b linear_fold_update (on no path:
   the JAX package never calls its reference) the same way with outputs
   poisoned, over n = 1, 2, 3, 4 slices (one group of sources) and 5
   and 9 (two and three groups), also at a peeled head, a body past
   1 MiB and operands with no shared 16-byte offset; K6 block_matmul,
   both kernels (``wgmma`` for aligned bfloat16, ``simt`` for the rest,
   each case checked to take the kernel the shape rule names), at
   GPT-2's MLP up-projection block ((2048, 768) @ (768, 3072)), the
   zero-3 block ((192, 3072) @ (3072, 256), a K split) and ragged, edge
   and mixed-dtype shapes, |err| <= tol * (|x| @ |w|) with tol 1e-5
   float32 and 2e-2 bfloat16, int32 exact; K7
   rma_apply, K8 rma_apply_strided (the grouped kernel's batch of one), K9
   rma_read (likewise) and K10 rma_permute_recv (likewise, outputs
   poisoned) for the three dtypes x
   put/replace/sum/min/max/prod, bitwise, at the one-sided paths' shapes
   (the 8192 x 8192 halo tile's self put and its columns at stride 8192, a
   128-element row of a 2**20 x 128 embedding shard) and a ragged
   unaligned one, at clamped, wrapped, dropped and filled edges; then the
   grouped K8 and K9 (rma_apply_strided_batch, rma_read_batch) bitwise
   against the loops of their single plain versions at the paths' batches
   (the halo's columns, the embedding update's 2048 rows and 2048
   lookups: more than one table each) and at the edges (overlapping
   descriptors, K7 inside a batch, unaligned payloads), and the grouped
   K10 (rma_permute_recv_batch) against the loop of its single plain
   pulls, outputs poisoned (see :func:`permute_batch_checks`). Then time
   each kernel (CUDA events, median of 10) beside its plain version, one
   PyTorch library call where one computes the same function, and its
   bound, and each also as launches queued behind a sleeping kernel,
   which hides the host's share of a call (the row's ``device_ms``; the
   HBM-bound ones with their rate and share of the bound; K5b also in
   bfloat16 and int32; K8, K9 and K10 also as the batches of the
   embedding path, beside index_add_, index_select and torch.cat);
3. the main paths, each with the kernels' launch counts zeroed by the
   ranks just before it and read just after: the launcher runs
   ``ompi_tpu_torch/examples/device_collectives.py`` (Allreduce,
   Reduce_scatter_block, Allgather, and on 4 ranks the ops outside the
   kernels, which coll/cuda hands to coll/device; 4 ranks on this card,
   then 3), then the same example under ``--mca device_plane on`` alone,
   so coll/device (the coll/xla counterpart) serves every slot: on 4
   ranks the three reductions at 1 MiB and 64 MiB float32 in every mode
   (K1-K3), Bcast float32 1 MiB from roots 0 and 3, Alltoall int32 at 1
   MiB and 64 MiB (K2's pull schedule), float16 SUM, int32 BXOR and bool
   LAND in every mode (K2, then the fold) and every slot on COMM_SELF;
   on 8 ranks (BASELINE config 2) Bcast float32 1 MiB from roots 0 and 7;
   the host collectives beside them (the example's ``host`` and
   ``staged`` families; see :func:`host_collectives_report`): on the
   4-rank coll/device job, numpy float32 SUM Allreduce through
   coll/tuned at 1 KiB, 1 MiB, 64 MiB and 256 MiB under its default
   decision (BASELINE config 3's host baseline), each beside coll/device's
   CUDA-tensor Allreduce of the same size, and at 1 MiB under each forced
   algorithm (``recursivedoubling``, ``ring``, ``rabenseifner``,
   ``basic``) in float32 and int32 (int32 exact and float32 ``basic``
   bitwise against a numpy rank-order fold, the other float32 algorithms
   within the example's ``HOST_RTOL`` of 1e-5 of the magnitudes), then
   the staged calls: a float64 Allreduce of 64 MiB, REPLACE and
   ``op.create`` Allreduces of 1 MiB and one float64 Iallreduce, CUDA
   tensors that coll/device hands to coll/accelerator, each bitwise equal
   to the same host collective on numpy copies, on the rank's own card,
   with ``coll_accelerator_staged`` equal to the staged calls; on the
   8-rank Bcast job, numpy float32 Bcast of 1 MiB from roots 0 and 7
   under coll/tuned's binomial (the default at 1 MiB) and forced
   ``linear``, bitwise, beside coll/device's (config 2's host baseline);
   then the rest of coll/device's slot table, a 4-rank job per family
   (:data:`REST_JOBS`): ``rooted`` (Reduce float32 64 MiB SUM to root 0
   in the three modes — '' takes the rooted schedule, K1's reduce-scatter
   then the root's K2 pull — and bfloat16 64 MiB MAX, the binomial tree;
   Gather float32 16 MiB a rank to root 3; Scatter float32 64 MiB from
   root 0; bitwise, None off the root, and a non-root's peak of allocated
   device bytes below n x the payload), ``vcoll`` (Allgatherv, Gatherv
   and Scatterv int32 and Reduce_scatter float32 64 MiB with skewed
   seeded counts; Alltoallv int32 in BASELINE config 5's pattern, 4096
   tokens of 4096 lanes a rank, with max_count and with the count round)
   and ``scan,barrier,nonblocking,persistent,self`` (Scan / Exscan
   float32 SUM and int32 MAX at 1 MiB; the device Barrier's p50; every
   ``I*`` call and Ibarrier under ``wait_all``, each equal to its
   blocking call, then Iallreduce 64 MiB + wait; each ``*_init`` started
   3 times on refilled buffers, then Allreduce_init 64 MiB's start +
   wait; every slot on COMM_SELF); and
   ``ompi_tpu_torch/examples/zero_training.py`` (the ZeRO step over
   GPT-2 small's full-width parameters: stage 2 unfused and fused,
   'linear' and ring, stage 1 (Allreduce_multi) 'linear' and 'ring', and
   stage 2 ``overlap=True`` (``Preduce_scatter_init``, the leaves
   Pready'd last first) 'linear' and 'ring', bitwise equal to unfused;
   GradientSync (``Pallreduce_init``) 'linear' bitwise equal to
   Allreduce_multi; ZeRO stage 3 (``Zero3Optimizer``, 15 layers, one
   persistent allgather each) 'linear' bitwise equal to stage 1 and
   'ring' within its stated bound of stage 2, every layer's request
   rebound, its forward pass with no prefetch miss and the residency
   within the shards plus two layers, and 12 c_fc.w products a pass
   through K6; plus Allreduce_multi against the per-leaf loop,
   allgather_matmul_dev and zero3_gather_matmul_dev; 4 ranks with all 12
   layers, then 3 ranks with 4), ``--mca device_plane on --mca coll_cuda
   on``; then, under
   ``--mca osc_cuda on``,
   ``halo_exchange.py`` (8192 x 8192 float32 tiles, 3 steps of
   Put_strided halo columns and a whole-tile self Put; 4 ranks, then 3 at
   4096 x 4096) and ``embedding_table.py`` (2**20 x 128 float32 shards,
   512 Get_epoch lookups and 512 Accumulate(SUM) gradient rows per rank;
   4 ranks, then 3 at 2**18 rows and 128), each fence reported with its
   rounds and the exchanges that moved them. Each rank checks its results
   (bitwise where the fold order is fixed, fused == unfused and stage-1
   'linear' == stage-2 'linear' bitwise, the windows against a plain
   recomputation) and reports its launch
   counts; every kernel of a path must have launched on it (on the
   coll/device jobs K2, and K1 and K3 where the kernels' reductions
   ran: the 8-rank Bcast needs K2 alone), no call of a kernel job may
   have staged through the host (``coll_accelerator_staged`` 0 on every
   rank, outside the ``staged`` family), and the
   4-rank training path's K6 launches must split 48 ``wgmma`` (bfloat16
   allgather_matmul) and 640 ``simt`` (float32, the zero-3 product and
   stage 3's 3 passes of 12 c_fc.w products),
   and the 4-rank embedding lookup must launch the grouped K10 once per
   reader and exchange;
4. the host plane (ob1 over self + sm + cma, no kernel of its own; see
   :func:`host_plane_phase`): the sm ring's C code built (the phase
   fails if it does not build, or if a rank of the p2p jobs ran the
   Python ring); ``hello.py`` and ``ring.py`` on 4 ranks,
   their stdout against the expected text; ``p2p_bandwidth.py`` on 2
   ranks (float32 CUDA tensors from a seeded generator, ping-pong p50 of
   10 round trips at 4 KiB, 1 MiB, 64 MiB and 256 MiB at the default
   chunk and 64 MiB as one chunk, every echo bitwise on the card; the
   stages' rates at the same sizes: a pinned D2H and H2D ``copy_`` and a
   host numpy ping-pong through the same pml; bfloat16 and int32 at
   1 MiB and a ragged 3 MiB + 4 B float32 message, bitwise) and its
   4-rank ``Sendrecv`` ring of 64 MiB CUDA tensors, bitwise; a CUDA
   tensor refused with ERR_ARG by ``comm.Send`` / ``Isend`` / ``Recv`` /
   ``Irecv`` on a one-rank job whose platform is the CPU;
5. the datatype engine (no kernel of its own; see
   :func:`datatype_phase`), before phase 4: in this process, the device
   convertor's pack and unpack (``datatype.device``: ``index_select`` /
   ``index_copy_`` over a cached element-index vector) of three layouts on
   the card, the halo column of an 8192 x 8192 float32 tile
   (``vector(8192, 1, 8192)``), a strided face of a 512^3 float32 field
   (``subarray``) and every other 4096-float block of a 256 MiB tensor
   (``vector(8192, 4096, 8192)``), each bitwise against the host
   convertor's bytes with the unpack's gaps (a poisoned template) kept,
   timed (first call and cached p50) beside a strided-view ``copy_`` of
   the same layout and the bound; then
   ``ompi_tpu_torch/examples/datatype_exchange.py`` on 4 ranks under
   ``--mca device_plane on --mca coll_cuda on`` (the halo column by
   tuple-form Send / Recv of CUDA tensors, ``Allreduce((tile, 1,
   column))`` under 'linear' and 'ring' and ``Bcast((tile, 1, column))``,
   each rank bitwise against the host fold, K1-K3 counted; their launches
   join the collectives jobs') and its ``--hetero`` mode on 2 host ranks
   with rank 1 big-endian (a struct Send / Recv both ways and an
   Allreduce);
6. PSCW and passive-target epochs on device windows (see
   :func:`am_phase`), after the one-sided paths of phase 3:
   ``ompi_tpu_torch/examples/osc_passive.py`` on 4 ranks under ``--mca
   device_plane on --mca osc_cuda on``, every window a ``CudaWindow`` on
   the host window's active-message service: the PSCW halo (8192 x 8192
   float32 tiles, 3 steps of two ``Put_strided`` columns, a row put and a
   ``Get_strided`` column between ring neighbours, bitwise equal to the
   same puts and a ``Get_epoch`` in fence epochs on a second window), the
   passive target on a 2**20 x 128 float32 shard (3 reps of 512
   Accumulate(SUM) rows under ``Lock_all``, ``Flush_all`` and 512 row
   Gets, then an exclusive-lock round of puts, bitwise against a numpy
   replay) and the atomics (64 ``Fetch_and_op`` a rank into rank 0, a
   permutation of 0..255, a ``Compare_and_swap`` ring, a NO_OP
   ``Get_accumulate``, a host-assisted BAND ``Accumulate``); the K7 / K8
   / K9 launches of every part must equal what the ranks derive from
   their schedules, and each part's epoch times, AM messages and a
   per-message split of a target's host time are printed;
7. the device-plane layer and the ops on it (see
   :func:`context_parallel_phase`): ``ompi_tpu_torch/examples/
   context_parallel.py`` on 4 ranks under ``--mca device_plane on``
   (coll/device serves ``parallel/``'s axis collectives): float32
   Allreduce of 64 MiB a rank over ``sp`` and a 2 x 2 mesh's ``dp`` and
   ``("dp", "sp")`` in the three modes ('linear' and 'ring' bitwise
   against the rank-order and ring folds), bfloat16 Reduce_scatter_block,
   Allgather, Alltoall and Shift of [4, 1024, 7168] and a float32 Scan,
   bitwise; ring attention and Ulysses at bench.py's attention shape
   (causal, bfloat16, [4, 256, 56, 128] q, k, v a rank) against ``mha``
   of the allgathered blocks, and a float32 pass at the reference test's
   shape; the MoE layer (d_model 7168, d_ff 28672, 8 experts, 2 a rank,
   capacity factor 1.25, 1024 tokens a rank) against the dense oracle on
   rank 0; the times of ring attention (and of its compute alone),
   Ulysses, ``mha`` of the whole
   sequence (and of ``mha_auto``, PyTorch's SDPA, checked against it),
   one ``permute_dev`` hop of the (k, v) block, the MoE layer and its two
   Alltoalls. K1, K2 and K3 must launch in the phase (K2
   in each of its three parts), and nothing may pass through the host
   (``coll_accelerator_staged`` and ``accel_p2p_{send,recv}`` 0);
8. the model layer (see :func:`model_phase`): ``ompi_tpu_torch/examples/
   transformer_training.py`` on 4 ranks under ``--mca device_plane on``:
   bench.py's d7168/L3 bfloat16 transformer (vocab 32768, 56 heads of
   128, d_ff 28672, T 1024, B 4, lr 1e-3, seeded weights and tokens drawn
   on each rank's device) trained on a 2 x 2 ``("tp", "sp")`` mesh, ring
   attention (one warm step, 3 timed), then the same widths at 4 layers
   on a ``("pp",)`` mesh of 4, 4 microbatches (one warm step, 2 timed);
   then, after the job has exited, the oracle in its own process: the
   port's one-rank ``Axes()`` step of each config on the same seeds,
   holding the job's first loss and each leaf's gradient at 4096 seeded
   positions within the example's ``LOSS_RTOL`` / ``GRAD_RTOL``, and
   timing bench.py's own step. K1 and K2 must launch in the tp x sp part,
   K2 in the pp part; the step times, tokens/s, TFLOP/s (bench.py's 6 x
   params x tokens) and every rank's peak memory are printed;
9. the device-epoch window (see :func:`device_epoch_phase`), after
   phase 6: ``ompi_tpu_torch/examples/device_epoch.py`` on 4 ranks under
   ``--mca device_plane on``, every window a ``DeviceEpochWindow``
   (``osc.win_create_device``) beside a ``CudaWindow`` over a copy of the
   same tensor taking the same ops in turns: the embedding epochs (2**20
   x 128 float32 shards, a warm and 3 timed SUM epochs of 512 ``Get``
   lookups and 512 ``Accumulate`` rows a rank, half of them on a shared
   hot set, then a MAX and a REPLACE epoch; every lookup and touched row
   bitwise against a numpy replay of every rank's ops in the reference's
   round order), the block epochs (a 2**26-float put to the right
   neighbour, K7, and a get from the left, K9 and K10; a warm and 3
   timed) and the IPC hand-off (rank 0 exports a 64 MiB CUDA tensor,
   rank 1 imports it onto its device, bitwise). Each epoch must equal the
   CudaWindow's bitwise; K8, K9 and K10 must launch in the embedding part
   and K7, K9 and K10 in the block part, each (and the CudaWindow's) at
   the count the ranks derive from the schedules; ``osc_device_epoch_op``
   must equal the ops queued, with nothing staged and no host-window op;
   the epoch times beside the CudaWindow's, part 2's rate, the rounds and
   exchanges, peak memory and arena bytes per rank are printed.
10. the hierarchy layer (see :func:`hier_phase`): three 4-rank jobs under
   ``--mca device_plane on --mca coll_cuda on``, the first two also under
   ``--mca coll_hier on --mca coll_hier_split 2x2 --mca coll_hier_inner
   ring``: ``hier_collectives.py`` (float32 SUM Allreduce at 64 KiB, 1
   MiB, 16 MiB and 256 MiB and bfloat16 at 16 MiB, the split-level
   schedule in turns with the flat coll/cuda schedule, one warm and 5
   timed calls of each, within 1e-5 x n x max|x| of a float64 sum;
   'linear' bitwise the flat 'linear'; Reduce_scatter_block 'linear',
   Allgather, Bcast from root 3 and Alltoall at 64 MiB bitwise the flat
   slots; the fused 'linear' multi over GPT-2 small's 148 leaves bitwise
   the flat fused form; 3 persistent starts; the per-level pvars against
   the byte model; 'ring' falling through), ``hier_dcn_compress.py`` (the
   256 MiB Allreduce with ``coll_hier_dcn_dtype`` off, bf16, fp8_e4m3 and
   fp8_e5m2 in turns: off bitwise before and after, the wire bytes at most
   1/2 (bf16) and 1/4 (fp8) of the nominal DCN bytes) and
   ``zero_training.py --error-feedback bf16,fp8_e4m3`` (3 steps each at
   GPT-2 small's width beside the exact 'linear' step: every loss at
   most 1e-2 above the exact step's, ``zero_ef_*`` as the plan derives).
   Each part's K1-K3 launches must equal what the ranks derive from their
   schedules.
11. the serving plane (see :func:`serve_phase`): two 4-rank jobs of
   ``ompi_tpu_torch/examples/moe_serving.py --width full`` (bench.py's
   MoE FFN, d_model 7168 and d_ff 28672, float32 experts drawn on the
   card: 4 a rank, 26.3 GB on the card) under ``--mca device_plane on
   --mca monitoring_level 1``: the flat job (16 experts, Zipf hotness 2.0,
   seed 23, 32 tokens a rank a request, capacity factor 1.25, 2 warm-up
   and 32 timed requests a policy) holds ``drop`` bitwise to
   ``ops/moe.moe_ffn``, ``reroute``'s conservation on every request and
   the merged report naming the hot expert; the ``dcn_overflow`` job,
   also under ``--mca coll_hier_split 2x2`` (8 experts, the slices
   replicas), holds one dispatch to a float64 oracle (max |out - oracle|
   <= 1e-4 x max |oracle|) with nothing dropped, and half the overflow's
   bytes as budget to its bound. Each policy's K2 launches must equal
   what the ranks derive from the schedules; prints rank 0's p50, p95,
   p99 and tokens/s per policy beside the HBM floor (every request
   streams every expert), the serve pvars, the drop and reroute rates,
   the plane's Alltoallv records and the peak memory per rank.
12. the tools plane (see :func:`tools_phase`): one 4-rank job of
   ``ompi_tpu_torch/examples/tools_plane.py`` under ``--mca device_plane
   on --mca coll_cuda on --mca osc_cuda on --mca pml_v 1 --mca
   pml_ob1_matching indexed --mca pml_accel_chunk_bytes 262144``, its
   ``btl_endpoint_connected`` handle allocated before Init: the sm
   wireup's event once per peer; a device ring of 1 MiB CUDA tensors
   (float32, bfloat16) bitwise, with ``pml_message_matched`` and PERUSE
   ``REQ_COMPLETE`` once per header and chunk, pml/v's log reassembled
   equal to the tensors' bytes and ``resend`` into fresh CUDA tensors
   bitwise; an MPI_T ``CvarHandle`` write of ``coll_cuda_bidir_min_bytes``
   moving a 4 MiB Allreduce from ``coll_cuda_bidir_bytes`` to
   ``coll_cuda_ring_bytes``, bitwise the same; a DeviceEpochWindow's
   BAND emitting ``osc_device_fallback`` once; CudaWindow fence, lock
   and PSCW epochs each emitting ``osc_epoch_transition``'s enter and
   exit, against a plain recomputation, a host-assisted BAND emitting
   ``osc_cuda_fallthrough``, and the K7-K10 launches (zeroed by the ranks
   before the part, read after) equal to what the ranks derive; then the
   ring's and the fence epoch's p50, with no handle and with a handle on
   every event, in turns (9 samples each).

13. the sessions plane (see :func:`sessions_phase`): one 4-rank job of
   ``ompi_tpu_torch/examples/sessions.py --device`` under ``--mca
   device_plane on --mca coll_cuda on --mca osc_cuda on``, with no
   COMM_WORLD (``Is_initialized()`` False throughout): ``Session_init``
   with ``mpi_memory_alloc_kinds`` ``system,mpi,cuda,cuda:device,
   cuda:managed,bogus`` granted as ``system,mpi,cuda,cuda:device``,
   ``MPIX_Query_cuda_support()`` True, a comm from ``mpi://WORLD`` by
   ``Comm_create_from_group``, device Allreduce(SUM) of 256 MiB float32
   and 64 MiB bfloat16 under 'ring' (K1 + K2) and 'linear' (K3), each
   bitwise its mode's plain fold, the float32 one timed in turns; a
   device Bcast with root 99 recovered by a callback (ERR_ROOT once on
   every rank) and the next Allreduce bitwise; a CudaWindow's Put and Rget
   to target 99 recovered by a window callback, the fence epoch after
   them bitwise against its numpy replay, and a Lock epoch's Put and Get;
   the K1-K3 and K7-K10 launches equal to what each rank derives; the
   reference's device fuzz schedule with nothing staged; Wtime / Wtick;
   the session's finalize leaving no device plane and no arena file, and a
   second session after it. Its Allreduce p50s print beside phase 3's
   under COMM_WORLD (the 4-rank coll/cuda collectives job, same call).
   Then a second job checks Abort: rank 2 calls ``mpi.Abort(comm, 7)``
   after a device Allreduce; the job must exit 7 within 60 s and leave no
   new ``ompi_tpu_torch_*`` file in /dev/shm.
14. the topology framework and the dynamic-process plane (see
   :func:`halo_phase`): one 4-rank job of
   ``ompi_tpu_torch/examples/neighbor_halo.py --device`` under coll/cuda
   (coll/device serves the neighbourhood slots: one arena exchange, K2
   landing each in-edge): tests/test_device_path.py's four device cases
   bitwise against the host path with nothing staged; the halo of an 8192
   x 8192 float32 tile a rank on a reordered 2 x 2 periodic cart, 20
   timed Neighbor_alltoall steps of four depth-8 strips under
   ``profile.timing`` (the count checked, the last step bitwise against
   its numpy replay); a 64 MiB float32 Neighbor_allgather a rank beside
   its HBM bound; the one exchange against the reference's 4 colour
   rounds of permute_dev at 1 MiB and 64 MiB, bitwise, timed in turns;
   64 MiB Allreduces on an Idup of the cart and a Cart_sub row, bitwise;
   and two children spawned by Comm_spawn, each with its own device plane
   and a bitwise 64 MiB Allreduce beside the parents' COMM_WORLD arenas,
   then the bridge and merged Allreduces, exiting 0. Each rank's and each
   child's K1-K3 launches per part must equal what it derived.
15. the I/O plane (see :func:`ckpt_phase`): four 4-rank jobs under
   ``--mca device_plane on --mca coll_cuda on``. F
   (``ompi_tpu_torch/examples/ckpt_training.py --phase full``): ZeRO stage
   2 'linear' with momentum at GPT-2 small's width (K3 a bucket, K2 four
   a bucket, a step), 8 timed steps, an ``AsyncCheckpointer`` snapshot
   begun after every odd step (the gathered parameters, this rank's shard
   kept, and the momentum shards as parts; the D2H side stream into one
   pinned buffer, digested on a background thread) and committed after
   the next (``fcoll.two_phase_write``, fsync, one manifest rename); the
   newest epoch's restore bitwise against the shards it was taken from,
   on every rank; prints the steps with and without a snapshot in flight,
   each rank's copy, drain, commit and restore times. C (``--phase
   crash``): epochs 1 and 2 commit, ``ckpt_inject_kill_chunk 0`` kills
   every rank in epoch 3's write: the job must exit non-zero, leave no
   manifest 3 and no new ``ompi_tpu_torch_*`` file in the shm dir. R
   (``--phase restore``): epoch 2 of C's directory, the optimizer rebuilt
   on the card, steps 4-8: the final digest must equal F's. Every rank's
   K2 / K3 launches of F, C and R as derived, nothing staged. P
   (``ompi_tpu_torch/examples/parallel_io.py --device``): each rank's 4096
   x 4096 float32 block of an 8192 x 8192 array written by one
   ``Write_all`` through a darray view (256 MiB), the file equal to
   numpy's row-major global array, the ordered records in rank order,
   ``Read_all`` bitwise; prints the Write_all rate beside the D2H alone.
   The checkpoint directories (under the smoke's own output) are removed,
   C's after phase 16.
16. the ingest and elastic planes (see :func:`ingest_elastic_phase`): two
   4-rank jobs under ``--mca device_plane on --mca coll_cuda on``. A
   (``ompi_tpu_torch/examples/streaming_ingest.py`` under ``--mca
   ingest_enable 1``): epoch 2 of phase 15's crash run restored through
   ``AsyncCheckpointer.restore_to_device``, every rank the whole GPT-2
   small tree (497.8 MB) in 4 MiB units over 4 upload streams x depth 2
   pinned slots into one device buffer, gated on the first leaf; the first
   step gates on its first bucket's leaves while the tail uploads
   (``ingest_early_starts`` >= 1 on every rank), the kernels' library
   loads on the plane's compile lane; the plane up, every leaf on the
   card, ``ingest_bytes`` the plan's; steps 4-8 with K2 16 x 37 and K3 4 x
   37 a step over the ranks, the digest F's, bitwise; prints each rank's
   upload wall, GB/s and gates' release times. B
   (``ompi_tpu_torch/examples/elastic_training.py`` under ``--mca ft 1
   --mca ingest_enable 1``, rank 2 SIGKILLed entering step 3; GPT-2
   small's shapes cut to 1 layer, host-state ZeRO stage 2 'linear' with
   ``async_checkpoint=True``): 16 MiB float32 device Allreduces ('linear',
   K3) on a dup of COMM_WORLD, on the shrunken comm of 3 and on the comm
   regrown by a ``spawn_replacement`` joiner admitted at step 5, each
   bitwise the host linear fold; the dup freed with its dead member
   (timed); the in-memory recovery bitwise the async checkpoint's replay
   on the shrunken comm; the joiner at parameter parity before its first
   step, its parameters through the ingest plane; the job exits 0, rank
   2's signal death the only failure the store holds; prints the
   recovery, free and join times and the host steps.
17. the observability planes (see :func:`observability_phase`): two jobs
   of ``ompi_tpu_torch/examples/observability.py`` under coll/cuda. A (4
   ranks, ``--mca trace_enable 1 --mca telemetry_enable 1 --mca
   prof_enable 1 --mca telemetry_port -1``): the device Allreduce (SUM,
   float32) at 1 MiB and 64 MiB, 'linear' and 'ring', and one
   ``Allreduce_multi`` step of ``fused_gradients.py``, timed in turns
   with the planes live and switched off: bitwise equal on and off and
   against each mode's fold, the live turns' ``launch`` spans equal to
   ``coll_cuda_launches`` / ``coll_device_launches``, the K1-K3 launches
   as derived; the four ranks' Chrome traces merged by ``python -m
   ompi_tpu_torch.trace merge`` (four pids, ``api`` and ``coll_cuda``,
   monotone timestamps per tid) and attributed to the ``staging`` and
   ``train`` phases by ``python -m ompi_tpu_torch.prof report``; prints
   rank 0's p50 on and off, a disabled guard's ns, the sampler's scraped
   page and the xfer lane's GB/s. B (2 ranks, ``telemetry_hang_timeout
   2``): rank 1 sleeps 3.5 s before a device Allreduce; rank 0's
   watchdog dumps the hang naming rank 1 and fires ``telemetry_hang``;
   the job exits 0. The phase fails past 60 s of wall. C runs inside phase
   11's drop job (``moe_serving.py --parts drop,reroute,monitoring``):
   the monitoring plane at levels 0, 1 and 2 in turns on the drop
   policy's decode, each level's p50 beside level 0's, the outputs
   bitwise at every level.
18. the launcher's multi-host, MPMD and binding forms and the tune, skew
   and tools planes (see :func:`multihost_phase`). A: ``--host
   nodeA:2:127.0.0.2,nodeB:2:127.0.0.3 --launch-agent local --bind-to
   core`` on the one card with ``tune_observe``, ``tune_dump``,
   ``skew_level 2``, ``skew_dump`` and ``coll_device_hier 2``:
   ``multihost.py --device``, a 256 MiB float32 SUM Allreduce on 4 ranks,
   8 calls a mode in turns under coll/cuda 'linear' (K3) and 'ring' (K1 +
   K2) and coll/device's 2 x 2 grid (K1 + K2), rank 3 200 ms late before
   every other call; bitwise the fold each mode fixes, each host's
   shared split of 2, each rank's affinity its core set, the K1-K3
   launches as derived; prints rank 0's p50 per mode. B: ``python -m
   ompi_tpu_torch.tune report --tables`` over A's dumps (a cuda-vs-device
   crossover), then a single-host 4-rank ``tune_observe.py --table`` job
   with ``coll_cuda_switchpoints`` at the H100 table it wrote
   (``tune_table_errors`` 0, the named algorithm ran every call,
   bitwise), then the report of that job's dumps ``--db`` A's merged
   document (its regression verdicts). C: ``python -m
   ompi_tpu_torch.skew report`` over A's dumps names rank 3, its lateness
   put down to compute, with the merge's error bar. D: an appfile, app 0
   (1 rank) and app 1 (3 ranks) of ``mpmd.py --device --msgq`` in one
   world on the card: MPI_APPNUM right on each rank, a device Allreduce
   across the apps bitwise, rank 1's SIGUSR1 dump showing its posted
   receive; ``python -m ompi_tpu_torch.tools.info --json`` lists
   coll/cuda, coll/device and osc_cuda. D's job and the C / D CLIs run
   beside B's read-back job. The phase fails past 60 s.

Output: one line per measurement with the card's name and power limit
(the examples' cases with their p50 and bus bandwidth among them),
then ``{"kernels": [...]}`` (K1-K3 launches summed over every
collectives job, coll/cuda's and coll/device's, the datatype job, phases
7, 8, 10, 11, 13, 14, 15, 16, 17 and 18 and the training path, K5 and K6's
two kernels from the training path, K7 and the K8, K9 and K10 batches
from the 4-rank one-sided paths, K7 and the per-call rows of K8 and K9
also from phase 6, K7 and the K8, K9 and K10 batches also from phase 9,
K7, the per-call K9 and the K8, K9 and K10 batches also from phase 12,
K1-K3, K7 and the per-call K9 also from phase 13; K5b and the per-call
row of K10 with 0 and a note), the card line, and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bfloat16 tensor cores, dense
N_RANKS = 4
MAIN_BYTES = 256 << 20  # the collectives path's largest Allreduce payload
#: each rank's payload of the ops outside the kernels (float16 SUM, int32
#: BXOR, bool LAND): the example's ``--ops-bytes``, passed to every job
OPS_BYTES = 1 << 20
#: K5: per-rank chunk of the training path's largest bucket (ln_f, wpe and
#: wte of GPT-2 small, 39,385,344 float32 over 4 ranks)
WTE_CHUNK = (2 + 1024 + 50257) * 768 // N_RANKS
MM_SHAPE = (2048, 768, 3072)  # K6: (m, d, f) of one block's product
#: K6 on the zero-3 path: GPT-2's c_fc.w row block over 4 ranks @ (3072, 256)
ZERO3_SHAPE = (768 // N_RANKS, 3072, 256)
#: zero_training.py's stage-3 matmul passes (its ``PASSES``), 12 c_fc.w
#: products each
ZERO3_PASSES = 3
#: the 4-rank training path's K6 launches per kernel (4 blocks per call:
#: 3 bfloat16 and 3 float32 allgather_matmul calls, 1 zero-3 call and the
#: stage-3 optimizer's 12 c_fc.w products a pass, a rank)
K6_PATH_SPLIT = {"block_matmul_wgmma": 3 * 4 * N_RANKS,
                 "block_matmul_simt":
                     (3 + 1 + 12 * ZERO3_PASSES) * 4 * N_RANKS}
SRC = "ompi_tpu_torch/coll/csrc/ring_kernels.cu"
GEMM_SRC = "ompi_tpu_torch/coll/csrc/gemm_kernels.cu"
RMA_SRC = "ompi_tpu_torch/osc/csrc/rma_kernels.cu"
HALO = 8192  # the halo path's tile side (8192 x 8192 float32 per rank)
EMB_ROWS, EMB_DIM = 1 << 20, 128  # the embedding path's shard per rank
SECTOR = 32  # bytes: what a strided element costs to read or write
#: the streaming engine's tile (stream.cuh, K1 and K7): the bytes of one
#: input a block takes, 256 threads x 4 vectors of 16 bytes; bodies below
#: STREAM_SMALL take one vector a thread (4 KiB tiles)
STREAM_TILE, STREAM_SMALL = 16384, 1 << 20
POISON = 0xA5  # every byte of an output before a bitwise check
#: K5b's source counts held against the plain version: one group of
#: sources with every load in flight (n <= FOLD_GROUP, the paths' 3 and 4
#: among them), then two and three groups
FOLD_GROUP = 4
FOLD_NS = (1, 2, 3, 4, 5, 9)
#: the embedding path's batches: rank 0's update fence applies 2048
#: gradient rows (512 from each of 4 ranks); a lookup fence reads 512 rows
EMB_UPDATES, EMB_LOOKUPS = N_RANKS * 512, 512
#: the note on K10's per-call row
K10_NOTE = ("the batch of one through the grouped kernel; the embedding "
            "lookup launches the batch, one per reader and exchange (the "
            "_batch row)")
REPS = 10
#: BASELINE config 3's Allreduce sizes, for the host baseline (4 ranks)
HOST_SIZES = "1k,1m,64m,256m"
LAUNCH_TIMEOUT = 200  # seconds per launcher job (fifteen of main_path)
BCAST_RANKS = 8  # BASELINE config 2's rank count, all on this card
#: the coll/device jobs of the rest of coll/xla's slot table: (--kinds,
#: sizes); 64 MiB payloads (float32 Reduce / Scatter / Reduce_scatter,
#: int32 v-collectives), BASELINE config 5's Alltoallv (4096 tokens of 4096
#: int32 lanes a rank), Scan / Exscan at 1 MiB
REST_JOBS = (
    ("rooted", ["--rooted-bytes", "64m", "--gather-bytes", "16m"]),
    ("vcoll", ["--vcoll-bytes", "64m", "--vcoll-lanes", "1024",
               "--a2av-tokens", "4096", "--a2av-lanes", "4096"]),
    ("scan,barrier,nonblocking,persistent,self",
     ["--scan-bytes", "1m", "--rooted-bytes", "64m",
      "--ops-bytes", str(OPS_BYTES)]))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        fail("nvidia-smi not found")
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def median_ms(fn, torch) -> float:
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def make(torch, numel, dtype, seed, dev, traps=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int32:
        return torch.randint(-(1 << 31), (1 << 31) - 1, (numel,),
                             generator=g, device=dev, dtype=torch.int32)
    x = torch.randn(numel, generator=g, device=dev).to(dtype)
    if not traps:
        return x
    # the numerical traps: NaN, and both zeros against each other
    x[3 + seed::1009] = float("nan")
    x[5::997] = 0.0
    x[7::991] = -0.0
    return x


def bits(torch, t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def compare(torch, got, exp):
    """(bitwise equal, max |got - exp| over non-NaN entries)."""
    eq = torch.equal(bits(torch, got), bits(torch, exp))
    if got.numel() == 0:
        return eq, 0.0
    if got.is_floating_point():
        both = ~(torch.isnan(got) | torch.isnan(exp))
        err = (got[both].float() - exp[both].float()).abs().max().item() \
            if both.any() else 0.0
        nan_ok = torch.equal(torch.isnan(got), torch.isnan(exp))
        return eq and nan_ok, err
    return eq, float((got.long() - exp.long()).abs().max().item())


def kernel_checks(torch, K, dev, card, engine):
    """Phase 2: every ring kernel against its plain version (K1's checks
    are ``engine``, from :func:`engine_checks`), then timings."""
    n = N_RANKS
    results = {"ring_rs_hop": engine["ring_rs_hop"], "ring_ag_hop": 0.0,
               "linear_fold": 0.0}
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        main = MAIN_BYTES // torch.empty(0, dtype=dtype).element_size()
        for numel, off in ((main, 0), (4099, 0), (1027, 1)):
            chunk = numel // n if numel == main else numel
            srcs = [make(torch, numel + off, dtype, 10 + p, dev)[off:]
                    for p in range(n)]
            a = srcs[0][:chunk]
            for op in K.OP_CODES:
                where = f"{dtype} {op} numel={numel} offset={off}"
                f1 = torch.empty_like(srcs[0])
                fp = torch.empty_like(srcs[0])
                K.linear_fold(srcs, f1, op)
                K.linear_fold_plain(srcs, fp, op)
                ok, err = compare(torch, f1, fp)
                if not ok:
                    fail(f"linear_fold != plain ({where}), err {err}")
                results["linear_fold"] = max(results["linear_fold"], err)
            g1, g2 = torch.empty_like(a), torch.empty_like(a)
            q1, q2 = torch.empty_like(a), torch.empty_like(a)
            K.ring_ag_hop(a, g1, dst2=g2)
            K.ring_ag_hop_plain(a, q1, dst2=q2)
            for got, exp in ((g1, q1), (g2, q2)):
                ok, err = compare(torch, got, exp)
                if not ok:
                    fail(f"ring_ag_hop != plain ({dtype} numel={numel} "
                         f"offset={off}), err {err}")
                results["ring_ag_hop"] = max(results["ring_ag_hop"], err)
            torch.cuda.synchronize()
            del srcs, a, f1, fp, g1, g2, q1, q2
    # K2 copies bytes: the dtypes coll/device's pull schedule gives it, at
    # the block each pull copies on the ops path (a rank's whole
    # OPS_BYTES payload), and ragged, unaligned blocks of 1-byte elements
    for dtype in (torch.float16, torch.bool, torch.uint8):
        block = OPS_BYTES // torch.empty(0, dtype=dtype).element_size()
        for numel, off in ((block, 0), (4099, 1), (1027, 3)):
            a = make(torch, numel + off, torch.float32, 40, dev,
                     traps=False)
            a = (a > 0 if dtype == torch.bool else a.to(dtype))[off:]
            g1 = poisoned(torch, numel, dtype, off, dev)
            g2 = poisoned(torch, numel, dtype, 0, dev)
            K.ring_ag_hop(a, g1, dst2=g2)
            for got in (g1, g2):
                if not torch.equal(got.view(torch.uint8),
                                   a.view(torch.uint8)):
                    fail(f"ring_ag_hop != plain ({dtype} numel={numel} "
                         f"offset={off})")
    torch.cuda.synchronize()
    print(f"kernels: K2 and K3 bitwise equal to their plain versions for "
          f"float32/bfloat16/int32 x SUM/PROD/MIN/MAX at {MAIN_BYTES} B "
          f"over {n} ranks and two ragged shapes; K2 also for float16, "
          f"bool and uint8 at the ops path's {OPS_BYTES} B block and at "
          f"odd, unaligned lengths, outputs poisoned [{card}]", flush=True)

    fused_checks(torch, K, dev, card, results)

    # timings at the main paths' shapes: K1-K3 float32 SUM over the
    # 256 MiB Allreduce, K5 float32 with momentum and scaling at the wte
    # chunk, K6 float32 (and bfloat16, printed) at the MLP block
    numel = MAIN_BYTES // 4
    chunk = numel // n
    srcs = [make(torch, numel, torch.float32, 20 + p, dev) for p in range(n)]
    carry, own = srcs[0][:chunk], srcs[1][:chunk]
    dst, dst2 = torch.empty_like(carry), torch.empty_like(carry)
    pair = torch.empty(2, chunk, device=dev)
    fold = torch.empty_like(srcs[0])
    cb = chunk * 4
    rows = []

    def row(*args, **kw):
        add_row(rows, results, card, SRC, *args, **kw)

    K.reset_launches()
    k1 = lambda: K.ring_rs_hop(carry, own, dst, "MPI_SUM")  # noqa: E731
    lib1 = lambda: torch.add(carry, own, out=dst)  # noqa: E731
    row("ring_rs_hop", "ompi_tpu/coll/pallas_kernels.py:529",
        median_ms(k1, torch),
        median_ms(lambda: K.ring_rs_hop_plain(carry, own, dst, "MPI_SUM"),
                  torch),
        median_ms(lib1, torch), 3 * cb, chunk,
        device_ms=device_line("ring_rs_hop", k1, "torch.add(out=)", lib1,
                              3 * cb, torch, card))
    k2 = lambda: K.ring_ag_hop(carry, dst, dst2=dst2)  # noqa: E731
    lib2 = lambda: torch.stack((carry, carry), out=pair)  # noqa: E731
    row("ring_ag_hop", "ompi_tpu/coll/pallas_kernels.py:565",
        median_ms(k2, torch),
        median_ms(lambda: K.ring_ag_hop_plain(carry, dst, dst2=dst2),
                  torch),
        median_ms(lib2, torch), 3 * cb, 0,
        device_ms=device_line("ring_ag_hop", k2, "torch.stack(out=)", lib2,
                              3 * cb, torch, card))
    k3 = lambda: K.linear_fold(srcs, fold, "MPI_SUM")  # noqa: E731
    lib3 = lambda: torch.sum(torch.stack(srcs), 0)  # noqa: E731
    row("linear_fold", "ompi_tpu/coll/pallas_kernels.py:389",
        median_ms(k3, torch),
        median_ms(lambda: K.linear_fold_plain(srcs, fold, "MPI_SUM"), torch),
        median_ms(lib3, torch), (n + 1) * numel * 4, (n - 1) * numel,
        device_ms=device_line("linear_fold", k3, "torch.stack().sum(0)",
                              lib3, (n + 1) * numel * 4, torch, card))
    del srcs, carry, own, dst, dst2, pair, fold

    k = WTE_CHUNK
    a, b, p, v = (make(torch, k, torch.float32, 30 + i, dev, traps=False)
                  for i in range(4))
    po, vo = torch.empty_like(p), torch.empty_like(v)
    c = [K.shard_const(x, torch.float32) for x in (0.01, 0.9, 1 / n)]

    def k5(fn):
        return lambda: fn(a, b, p, v, po, vo, c[0], c[1], c[2])

    no_lib5 = ("no single PyTorch call reduces two chunks and applies the "
               "momentum-SGD update")
    row("ring_rs_update_hop", "ompi_tpu/coll/pallas_kernels.py:601",
        median_ms(k5(K.ring_rs_update_hop), torch),
        median_ms(k5(K.ring_rs_update_hop_plain), torch), None,
        6 * 4 * k, 6 * k, why_no_library=no_lib5,
        device_ms=device_line("ring_rs_update_hop", k5(K.ring_rs_update_hop),
                              no_lib5, None, 6 * 4 * k, torch, card))
    del a, b, p, v, po, vo

    srcs = [make(torch, k, torch.float32, 34 + i, dev, traps=False)
            for i in range(n)]
    p, v = srcs[0].clone(), srcs[1].clone()
    po, vo = torch.empty_like(p), torch.empty_like(v)

    def k5b(fn):
        return lambda: fn(srcs, p, v, po, vo, c[0], c[1], c[2])

    no_lib5b = ("no single PyTorch call folds n slices and applies the "
                "momentum-SGD update")
    row("linear_fold_update", "ompi_tpu/coll/pallas_kernels.py:447",
        median_ms(k5b(K.linear_fold_update), torch),
        median_ms(k5b(K.linear_fold_update_plain), torch), None,
        (n + 4) * 4 * k, (n + 4) * k, why_no_library=no_lib5b,
        note="no path runs it: nothing in the JAX package calls "
             "linear_reduce_scatter_update (the 'linear' fused slot runs "
             "K3 and the eager update)",
        device_ms=device_line("linear_fold_update",
                              k5b(K.linear_fold_update), no_lib5b, None,
                              (n + 4) * 4 * k, torch, card))
    del srcs, p, v, po, vo
    # K5b's rate in the other dtypes (n = 4, momentum and scaling)
    for dtype in (torch.bfloat16, torch.int32):
        es = torch.empty(0, dtype=dtype).element_size()
        srcs = [make(torch, k, dtype, 34 + i, dev, traps=False)
                for i in range(n)]
        p, v = srcs[0].clone(), srcs[1].clone()
        po, vo = torch.empty_like(p), torch.empty_like(v)
        cd = [K.shard_const(x, dtype) for x in (0.01, 0.9, 1 / n)]
        device_line(f"linear_fold_update {str(dtype).split('.')[-1]}",
                    lambda: K.linear_fold_update(srcs, p, v, po, vo, *cd),
                    no_lib5b, None, (n + 4) * es * k, torch, card)
        del srcs, p, v, po, vo

    def gemm(*args, **kw):
        add_row(rows, results, card, GEMM_SRC, *args, **kw)

    for name, dtype, rate, (m, d, f), record in (
            ("block_matmul_wgmma", torch.bfloat16, BF16_OPS_PER_S, MM_SHAPE,
             True),
            ("block_matmul_simt", torch.float32, F32_OPS_PER_S, MM_SHAPE,
             True),
            ("block_matmul_simt (zero-3)", torch.float32, F32_OPS_PER_S,
             ZERO3_SHAPE, False)):
        x = torch.randn(m, d, device=dev).to(dtype)
        w = torch.randn(d, f, device=dev).to(dtype)
        o = torch.empty(m, f, device=dev, dtype=dtype)
        if f"block_matmul_{K.block_matmul_variant(x, w, o)}" != \
                name.split()[0]:
            fail(f"{name}: the shape rule picks another kernel")
        kern = lambda: K.block_matmul(x, w, o)  # noqa: E731
        lib = lambda: torch.matmul(x, w, out=o)  # noqa: E731
        dev_ms = queued_ms(kern, torch)
        gemm(name, "ompi_tpu/coll/pallas_kernels.py:659",
             median_ms(kern, torch),
             median_ms(lambda: K.block_matmul_plain(x, w, o), torch),
             median_ms(lib, torch),
             (m * d + d * f + m * f) * x.element_size(), 2 * m * d * f,
             ops_per_s=rate, record=record, device_ms=dev_ms)
        print(f"kernel {name} queued (50 launches behind a sleeping "
              f"kernel): {dev_ms:.4f} ms, torch.matmul "
              f"{queued_ms(lib, torch):.4f} ms [{card}]", flush=True)
        del x, w, o
    torch.cuda.empty_cache()
    return rows


def queued_ms(fn, torch, n=50, host_ms=None) -> float:
    """Device ms per call of ``fn`` with its launches queued: a sleeping
    kernel holds the stream while the host enqueues n calls (the sleep
    outlasts four times the host's time for them), so the events time the
    device alone (median of 5). A list ``host_ms`` receives the median
    host ms of enqueueing one call, which nothing on the card waits on."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    cycles = max(50_000_000, int(4 * n * host_s * 2e9))
    times, hosts = [], []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)  # tens of ms at H100 clocks, or more
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        hosts.append((time.perf_counter() - t0) * 1e3 / n)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    if host_ms is not None:
        host_ms.append(sorted(hosts)[len(hosts) // 2])
    times.sort()
    return times[len(times) // 2]


def device_line(name, fn, lib_name, lib, nbytes, torch, card) -> float:
    """Print a kernel's and its library call's (None: none) device-only
    time (:func:`queued_ms`) with the rate and the share of the HBM bound;
    returns the kernel's."""
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms = queued_ms(fn, torch)
    lib_ms = queued_ms(lib, torch) if lib is not None else None
    lib_part = f"{lib_name} {lib_ms:.4f} ms, " \
        f"{nbytes / lib_ms / 1e9:.3f} TB/s" if lib is not None else \
        f"library none ({lib_name})"
    print(f"kernel {name} queued (device only): {ms:.4f} ms, "
          f"{nbytes / ms / 1e9:.3f} TB/s, {bound / ms:.0%} of its bound; "
          f"{lib_part} [{card}]", flush=True)
    return ms


def poisoned(torch, numel, dtype, off, dev):
    """An output of numel elements at element offset ``off`` of a fresh
    allocation, every byte POISON: a stale or missing write shows."""
    t = torch.empty(numel + off, dtype=dtype, device=dev)[off:]
    t.view(torch.uint8).fill_(POISON)
    return t


def engine_checks(torch, K, O, dev, card):
    """Phase 2 for the kernels on the streaming engine (``stream.cuh``):
    K1 ring_rs_hop and K7 rma_apply bitwise against their plain versions
    for float32/bfloat16/int32 x every op (K7: put, replace, sum, prod,
    min, max), inputs carrying NaN and +-0, every output poisoned first (a
    put's window too). Shapes: the paths' (K1's 64 MiB, 256 KiB and 256 B
    chunks, each with and without dst2; K7's 2**26-element tile put and a
    128-element row) and the engine's edges: a span shorter than one
    tile, spans ending at a tile boundary, one vector past it and one
    element past that, both sides of the small-span switch; operands 16-byte but not 128-byte aligned, one
    element off 16 bytes on every operand (a head of elements before the
    bulk body) and on some (no body: the element loop); K7 at a clamped,
    unaligned start on the tile. Returns the max abs errors."""
    err = {"ring_rs_hop": 0.0, "rma_apply": 0.0}

    def check(name, got, want, where):
        ok, e = compare(torch, got, want)
        if not ok:
            fail(f"{name} != plain on the engine ({where}), err {e}")
        err[name] = max(err[name], e)

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        es = torch.empty(0, dtype=dtype).element_size()
        vec = 16 // es
        chunk = MAIN_BYTES // N_RANKS // es
        # (elements, element offsets of carry, own and the outputs)
        spans = [(chunk, (0, 0, 0)), (chunk + vec, (0, 0, 0)),
                 (chunk + vec + 1, (0, 0, 0)), ((1 << 18) // es, (0, 0, 0)),
                 (256 // es, (0, 0, 0)),
                 ((STREAM_TILE - 16) // es, (0, 0, 0)),
                 ((STREAM_SMALL - 16) // es, (0, 0, 0)),
                 (STREAM_SMALL // es, (0, 0, 0)),
                 ((1 << 20) // es + vec + 1, (vec, vec, vec)),
                 ((1 << 20) // es + vec + 1, (1, 1, 1)),
                 ((1 << 20) // es + vec + 1, (1, 1, 0)),
                 (4099, (1, 0, 1))]
        for numel, (oa, ob, od) in spans:
            a = make(torch, numel + oa, dtype, 90, dev)[oa:]
            b = make(torch, numel + ob, dtype, 91, dev)[ob:]
            for op in K.OP_CODES:
                want = torch.empty_like(a)
                K.ring_rs_hop_plain(a, b, want, op)
                for two in (False, True):
                    d = poisoned(torch, numel, dtype, od, dev)
                    d2 = poisoned(torch, numel, dtype, od, dev) if two \
                        else None
                    K.ring_rs_hop(a, b, d, op, dst2=d2)
                    where = (f"{dtype} {op} {numel} elements, offsets "
                             f"{(oa, ob, od)}, dst2 {two}")
                    for got in (d, d2) if two else (d,):
                        check("ring_rs_hop", got, want, where)
            torch.cuda.synchronize()
            del a, b, want, d, d2
        tile = HALO ** 2
        big, whole = (1 << 25) // es, (1 << 24) // es  # 32 and 16 MiB
        # (window elements, payload elements, payload offset, disp)
        applies = [(tile, tile, 0, 0), (1 << 20, EMB_DIM, 0, 1000 * EMB_DIM),
                   (tile, tile - 3, 0, 5),  # clamped to 3: the element loop
                   (tile, tile - 3, 3, 5),  # both off: a head, then bulk
                   (big, (STREAM_TILE - 16) // es, 0, 0),
                   (big, whole, 0, vec),  # 16-byte, not 128-byte aligned
                   (big, whole + vec, 0, 0), (big, whole + vec + 1, 0, 0)]
        for size, k, po, d in applies:
            base = make(torch, size, dtype, 92, dev)
            pay = make(torch, k + po, dtype, 93, dev)[po:]
            for kind in O.KINDS:
                w0 = base
                if kind in ("put", "replace"):
                    w0 = poisoned(torch, size, dtype, 0, dev)
                got, want = w0.clone(), w0.clone()
                O.rma_apply(got, pay, d, kind)
                O.rma_apply_plain(want, pay, d, kind)
                check("rma_apply", got, want,
                      f"{dtype} {kind} window {size} payload {k} at offset "
                      f"{po}, disp {d}")
                del got, want, w0
            torch.cuda.synchronize()
            del base, pay
        torch.cuda.empty_cache()
    print(f"kernels: K1 and K7 on the streaming engine bitwise equal to "
          f"their plain versions for float32/bfloat16/int32 x every op, "
          f"outputs poisoned, at the paths' shapes (64 MiB, 256 KiB, 256 B "
          f"chunks with and without dst2; the {HALO} x {HALO} tile, a "
          f"{EMB_DIM}-element row) and the engine's edges (below a "
          f"{STREAM_TILE}-byte tile, at a tile boundary, a vector and an "
          f"element past it, both sides of {STREAM_SMALL} B; 16-byte but "
          f"not 128-byte aligned, a peeled head, mixed offsets, a clamped "
          f"unaligned start) [{card}]",
          flush=True)
    return err


def add_row(rows, results, card, source, name, replaces, ms, plain_ms,
            lib_ms, nbytes, ops, ops_per_s=F32_OPS_PER_S, record=True,
            why_no_library="", note="", device_ms=None):
    """Print one kernel's timing line; with ``record``, add its row to
    the kernels JSON (launches are filled in from the main paths; a row
    with a ``note`` is of a kernel no path runs, and keeps 0;
    ``device_ms``, where measured, is its time queued behind a sleeping
    kernel)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    bound = max(t_bytes, t_ops) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    if record:
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": results[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms})
        if device_ms is not None:
            rows[-1]["device_ms"] = device_ms
        if note:
            rows[-1]["note"] = note
    lib = f"library {lib_ms:.4f} ms" if lib_ms is not None else \
        f"library none: {why_no_library}"
    print(f"kernel {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
          f"{lib}, bound {bound:.4f} ms by {by}) at {nbytes} B moved, "
          f"{ops} operations [{card}]", flush=True)


def fused_checks(torch, K, dev, card, results):
    """Phase 2 for the training path's kernels: K5 and K5b bitwise, K6's
    two kernels to their tolerance, each against its plain version on the
    card."""
    for name in ("ring_rs_update_hop", "linear_fold_update"):
        results[name] = 0.0

    def held(name, got, exp, mom, where):
        for j in range(2 if mom else 1):
            ok, err = compare(torch, got[j], exp[j])
            if not ok:
                fail(f"{name} != plain ({where} momentum={mom}), err {err}")
            results[name] = max(results[name], err)

    n = N_RANKS
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        es = torch.empty(0, dtype=dtype).element_size()
        c = [K.shard_const(x, dtype) for x in (0.01, 0.9, 1 / n)]
        # (elements, element offsets of the sources, of p / v, of the outputs)
        shapes = [(WTE_CHUNK, (0, 0, 0)), (4099, (0, 0, 0)),
                  (1027, (1, 1, 1)),  # a peeled head, then the body
                  (STREAM_SMALL // es + 3, (1, 1, 1)),  # a body past 1 MiB
                  (1027, (1, 0, 1))]  # no shared offset: the element loop
        for numel, (os_, op_, oo) in shapes:
            a, b, p, v = (make(torch, numel + op_, dtype, 40 + i, dev,
                               traps=False)[op_:] for i in range(4))
            srcs = [make(torch, numel + os_, dtype, 44 + i, dev,
                         traps=False)[os_:] for i in range(max(FOLD_NS))]
            for mom in (False, True):
                for inv in (False, True):
                    args = (p, v if mom else None)
                    consts = (c[0], c[1] if mom else None,
                              c[2] if inv else None)
                    where = (f"{dtype} numel={numel} offsets "
                             f"{(os_, op_, oo)} inv={inv}")
                    if os_ == op_:  # K5's shapes: fresh outputs
                        got = [torch.empty_like(p), torch.empty_like(p)]
                        exp = [torch.empty_like(p), torch.empty_like(p)]
                        K.ring_rs_update_hop(a, b, *args, got[0],
                                             got[1] if mom else None,
                                             *consts)
                        K.ring_rs_update_hop_plain(a, b, *args, exp[0],
                                                   exp[1] if mom else None,
                                                   *consts)
                        held("ring_rs_update_hop", got, exp, mom, where)
                    for k in FOLD_NS:
                        got = [poisoned(torch, numel, dtype, oo, dev)
                               for _ in range(2)]
                        exp = [torch.empty_like(p), torch.empty_like(p)]
                        K.linear_fold_update(srcs[:k], *args, got[0],
                                             got[1] if mom else None,
                                             *consts)
                        K.linear_fold_update_plain(srcs[:k], *args, exp[0],
                                                   exp[1] if mom else None,
                                                   *consts)
                        held("linear_fold_update", got, exp, mom,
                             f"{where} n={k}")
            torch.cuda.synchronize()
            del a, b, p, v, srcs, got, exp
    print(f"kernels: K5 bitwise equal to its plain version for "
          f"float32/bfloat16/int32, with and without momentum and scaling, "
          f"at {WTE_CHUNK} elements and a ragged shape; K5b the same, "
          f"outputs poisoned, over n = {', '.join(map(str, FOLD_NS))} "
          f"slices (groups of {FOLD_GROUP} sources, every load of a group "
          f"in flight) at {WTE_CHUNK} elements, ragged shapes, a peeled "
          f"head, a body past {STREAM_SMALL} B and no shared 16-byte "
          f"offset [{card}]", flush=True)

    results["block_matmul_wgmma"] = results["block_matmul_simt"] = 0.0
    g = torch.Generator(device=dev).manual_seed(50)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    # (m, d, f), x dtype, w dtype, the kernel the shape rule must pick
    cases = [(MM_SHAPE, torch.bfloat16, torch.bfloat16, "wgmma"),
             (MM_SHAPE, torch.float32, torch.float32, "simt"),
             (MM_SHAPE, torch.int32, torch.int32, "simt"),
             (ZERO3_SHAPE, torch.float32, torch.float32, "simt"),
             (ZERO3_SHAPE, torch.int32, torch.int32, "simt"),
             # wgmma at its edges: ragged tiles, a single row, 8 columns
             ((130, 72, 200), torch.bfloat16, torch.bfloat16, "wgmma"),
             ((1, 64, 8), torch.bfloat16, torch.bfloat16, "wgmma"),
             # rows TMA cannot stride (140 and 2002 bytes): the simt kernel,
             # the second with a K split
             ((130, 70, 200), torch.bfloat16, torch.bfloat16, "simt"),
             ((130, 1001, 70), torch.bfloat16, torch.bfloat16, "simt"),
             ((130, 70, 200), torch.float32, torch.float32, "simt"),
             ((130, 70, 200), torch.int32, torch.int32, "simt"),
             ((1, 5, 3), torch.float32, torch.float32, "simt"),
             ((33, 65, 17), torch.int32, torch.bfloat16, "simt"),
             ((33, 64, 16), torch.int32, torch.bfloat16, "wgmma"),
             ((33, 65, 17), torch.float32, torch.bfloat16, "simt"),
             ((33, 65, 17), torch.int32, torch.float32, "simt")]
    errs = {}
    for (m, d, f), xdt, wdt, want in cases:
        def operand(shape, dt):
            if dt == torch.int32:
                lim = 1 << 31 if xdt == wdt else 50
                return torch.randint(-lim, lim - 1, shape, generator=g,
                                     device=dev, dtype=dt)
            return torch.randn(shape, generator=g, device=dev).to(dt)

        x, w = operand((m, d), xdt), operand((d, f), wdt)
        dt = torch.promote_types(xdt, wdt)
        got = torch.empty(m, f, device=dev, dtype=dt)
        exp = torch.empty_like(got)
        where = f"{tuple(x.shape)} {xdt} @ {tuple(w.shape)} {wdt}"
        before = dict(K.block_matmul.variants)
        K.block_matmul(x, w, got)
        took = [v for v, c in K.block_matmul.variants.items()
                if c != before[v]]
        if took != [want]:
            fail(f"block_matmul took {took}, not the {want} kernel "
                 f"({where})")
        K.block_matmul_plain(x, w, exp)
        torch.cuda.synchronize()
        name = f"block_matmul_{want}"
        if dt == torch.int32:
            if not torch.equal(got, exp):
                fail(f"block_matmul {want} != plain ({where})")
            continue
        mag = x.to(dt).float().abs() @ w.to(dt).float().abs()
        diff = (got.float() - exp.float()).abs()
        if not bool((diff <= tol[dt] * mag).all()):
            bad = (diff > tol[dt] * mag).nonzero()[:5].tolist()
            fail(f"block_matmul {want} != plain beyond {tol[dt]} x (|x| @ "
                 f"|w|) ({where}); first bad (row, col) {bad}, got "
                 f"{[got[i][j].item() for i, j in bad]}, plain "
                 f"{[exp[i][j].item() for i, j in bad]}")
        err = diff.max().item()
        key = f"{want} {str(dt).split('.')[-1]}"
        errs[key] = max(errs.get(key, 0.0), err)
        results[name] = max(results[name], err)
        del x, w, got, exp, mag, diff
    print(f"kernels: K6 within tol x (|x| @ |w|) of its plain version "
          f"(float32 1e-5, bfloat16 2e-2; max abs err {errs}), int32 "
          f"exact, each case through the kernel the shape rule names, at "
          f"{MM_SHAPE}, {ZERO3_SHAPE} and ragged, edge and mixed-dtype "
          f"shapes [{card}]", flush=True)


def rma_checks(torch, O, dev, card, engine):
    """Phase 2 for the one-sided paths' kernels: K7-K10 bitwise against
    their plain versions for float32/bfloat16/int32 x every kind, at the
    paths' shapes (the halo tile's 64M-element self put and its
    8192-element columns at stride 8192; an embedding row of 128 in a
    2**20 x 128 shard) and a ragged, unaligned one, at the edge
    displacements, inputs carrying NaN and +-0 (K7's engine edges are
    ``engine``, from :func:`engine_checks`); then each kernel timed
    beside its plain version, its bound and one PyTorch call."""
    tile, col, emb = HALO ** 2, HALO, EMB_ROWS * EMB_DIM
    rag, kr = 4099, 1027
    results = {k.__name__: 0.0 for k in O.KERNELS}
    results["rma_apply"] = engine["rma_apply"]

    def check(name, got, want, where):
        ok, err = compare(torch, got, want)
        if not ok:
            fail(f"{name} != plain ({where}), err {err}")
        results[name] = max(results[name], err)

    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        big = make(torch, tile, dtype, 60, dev)
        row_win = make(torch, emb, dtype, 61, dev)
        ragged = make(torch, rag + 1, dtype, 62, dev)[1:]
        counter = make(torch, 4, dtype, 65, dev)
        # (window, payload elements, stride, displacements); the AM
        # phase's shapes among them: a row's interior into the last row,
        # a column above the last row, one element of a counter window
        cases = [(big, tile, 1, (0, 3, -1)),
                 (big, col, col, (0, col - 1, tile - 5, -3, -tile - 9)),
                 (big, col - 2, 1, (tile - col + 1,)),
                 (big, col - 1, col, (1,)),
                 (counter, 1, 1, (0, 1, 2, 3)),
                 (row_win, EMB_DIM, 1, (0, emb - EMB_DIM, emb - 100, -3,
                                        -emb - 5, 1 << 40)),
                 (ragged, kr, 1, (0, rag - kr, 4000, -5, -5000)),
                 (ragged, kr, 2, (0, rag - 2 * kr + 1, 3000, -7))]
        for w0, k, stride, disps in cases:
            pay = make(torch, k + 1, dtype, 63, dev)[1:] if w0 is ragged \
                else make(torch, k, dtype, 64, dev)
            for d in disps:
                where = (f"{dtype} window {w0.numel()} payload {k} "
                         f"stride {stride} disp {d}")
                for kind in O.KINDS:
                    got, want = w0.clone(), w0.clone()
                    O.apply(got, pay, d, kind, stride)
                    if stride == 1:
                        O.rma_apply_plain(want, pay, d, kind)
                    else:
                        O.rma_apply_strided_plain(want, pay, d, stride,
                                                  kind)
                    check("rma_apply" if stride == 1 else
                          "rma_apply_strided", got, want, f"{where} {kind}")
                for s in ((stride,) if stride != 1 else (1, -3, 0)):
                    got = O.rma_read(w0, d, s, torch.empty_like(pay))
                    want = torch.empty_like(pay)
                    O.rma_read_plain(w0, d, s, want)
                    check("rma_read", got, want, f"{where} read stride {s}")
            for src in (pay, None):
                got = O.rma_permute_recv(src, poisoned(torch, k, dtype, 0,
                                                       dev))
                want = torch.empty_like(pay)
                O.rma_permute_recv_plain(src, want)
                check("rma_permute_recv", got, want,
                      f"{dtype} payload {k} src {src is not None}")
            torch.cuda.synchronize()
            del got, want, pay
        del big, row_win, ragged, counter
        torch.cuda.empty_cache()
    print(f"kernels: K7-K10 bitwise equal to their plain versions for "
          f"float32/bfloat16/int32 x {len(O.KINDS)} kinds at the halo tile "
          f"({tile} elements, columns of {col} at stride {col}, a row's "
          f"{col - 2}-element interior, a column of {col - 1}), an "
          f"embedding row ({EMB_DIM} of {emb}), one element of a 4-element "
          f"counter and ragged unaligned shapes, clamped, wrapped, dropped "
          f"and filled edges [{card}]",
          flush=True)
    rma_batch_checks(torch, O, dev, card, results)
    permute_batch_checks(torch, O, dev, card, results)

    rows = []

    def row(*args, **kw):
        add_row(rows, results, card, RMA_SRC, *args, **kw)

    big = make(torch, tile, torch.float32, 70, dev, traps=False)
    pay = make(torch, tile, torch.float32, 71, dev, traps=False)
    k7 = lambda: O.rma_apply(big, pay, 0, "put")  # noqa: E731
    lib7 = lambda: big[:tile].copy_(pay)  # noqa: E731
    row("rma_apply", "ompi_tpu/osc/pallas_kernels.py:92",
        median_ms(k7, torch),
        median_ms(lambda: O.rma_apply_plain(big, pay, 0, "put"), torch),
        median_ms(lib7, torch), 2 * tile * 4, 0,
        device_ms=device_line("rma_apply", k7, "copy_", lib7, 2 * tile * 4,
                              torch, card))
    land = torch.empty_like(pay)
    k10 = lambda: O.rma_permute_recv(pay, land)  # noqa: E731
    lib10 = lambda: land.copy_(pay)  # noqa: E731
    row("rma_permute_recv", "ompi_tpu/osc/pallas_kernels.py:192",
        median_ms(k10, torch),
        median_ms(lambda: O.rma_permute_recv_plain(pay, land), torch),
        median_ms(lib10, torch), 2 * tile * 4, 0, note=K10_NOTE,
        device_ms=device_line("rma_permute_recv", k10, "copy_", lib10,
                              2 * tile * 4, torch, card))
    # the 4-rank embedding lookup's exchange at one reader: a block of
    # EMB_LOOKUPS / N_RANKS rows from each owner's staged region, landed
    # end to end in one tensor (one grouped launch)
    per_src = EMB_LOOKUPS // N_RANKS * EMB_DIM
    staged = [pay[q * 2 * per_src:q * 2 * per_src + per_src]
              for q in range(N_RANKS)]
    got = land[:N_RANKS * per_src]
    pulls = [(staged[q], got[q * per_src:(q + 1) * per_src])
             for q in range(N_RANKS)]
    k10b = lambda: O.rma_permute_recv_batch(pulls)  # noqa: E731
    lib10b = lambda: torch.cat(staged, out=got)  # noqa: E731
    nb = 2 * N_RANKS * per_src * 4
    row("rma_permute_recv_batch", "ompi_tpu/osc/pallas_kernels.py:192",
        median_ms(k10b, torch),
        median_ms(lambda: O.rma_permute_recv_batch_plain(pulls), torch),
        median_ms(lib10b, torch), nb, 0,
        device_ms=device_line("rma_permute_recv_batch", k10b,
                              "torch.cat(out=)", lib10b, nb, torch, card))
    del staged, got, pulls
    colp = pay[:col].clone()
    strided = torch.as_strided(big, (col,), (col,), col - 1)
    k8 = lambda: O.rma_apply_strided(big, colp, col - 1, col,  # noqa: E731
                                     "put")
    lib8 = lambda: strided.copy_(colp)  # noqa: E731
    dev_ms = queued_ms(k8, torch)
    row("rma_apply_strided", "ompi_tpu/osc/pallas_kernels.py:111",
        median_ms(k8, torch),
        median_ms(lambda: O.rma_apply_strided_plain(big, colp, col - 1, col,
                                                    "put"), torch),
        median_ms(lib8, torch), col * (2 * SECTOR + 4), 0,
        device_ms=dev_ms)
    print(f"kernel rma_apply_strided queued (device only): "
          f"{dev_ms:.4f} ms, strided copy_ "
          f"{queued_ms(lib8, torch):.4f} ms [{card}]", flush=True)
    target = O.Target(big)
    cols = pay[:2 * col].clone()
    halo = lambda: target.apply(  # noqa: E731
        [cols], [(0, 0, col, 0, col, "put"), (0, col, col, col - 1, col,
                                               "put")])
    print(f"kernel rma_apply_strided_batch (the halo path's two columns, "
          f"one launch): {median_ms(halo, torch):.4f} ms, queued "
          f"{queued_ms(halo, torch):.4f} ms, bound "
          f"{2 * col * (2 * SECTOR + 4) / HBM_BYTES_PER_S * 1e3:.6f} ms "
          f"[{card}]", flush=True)
    out = torch.empty(col, device=dev)
    row("rma_read (strided)", "ompi_tpu/osc/pallas_kernels.py:133",
        median_ms(lambda: O.rma_read(big, col - 2, col, out), torch),
        median_ms(lambda: O.rma_read_plain(big, col - 2, col, out), torch),
        median_ms(lambda: torch.as_strided(big, (col,), (col,),
                                           col - 2).clone(), torch),
        col * (SECTOR + 4), 0, record=False)
    del big, pay, land, colp, strided, out, target, cols
    win = make(torch, emb, torch.float32, 72, dev, traps=False)
    r128 = make(torch, EMB_DIM, torch.float32, 73, dev, traps=False)
    out = torch.empty_like(r128)
    d = (EMB_ROWS // 3) * EMB_DIM
    view = win[d:d + EMB_DIM]
    k9 = lambda: O.rma_read(win, d, 1, out)  # noqa: E731
    lib9 = lambda: view.clone()  # noqa: E731
    dev_ms = queued_ms(k9, torch)
    row("rma_read", "ompi_tpu/osc/pallas_kernels.py:133",
        median_ms(k9, torch),
        median_ms(lambda: O.rma_read_plain(win, d, 1, out), torch),
        median_ms(lib9, torch), 2 * EMB_DIM * 4, 0,
        device_ms=dev_ms)
    print(f"kernel rma_read queued (device only): {dev_ms:.4f}"
          f" ms, clone() {queued_ms(lib9, torch):.4f} ms [{card}]",
          flush=True)
    row("rma_apply (sum, one row)", "ompi_tpu/osc/pallas_kernels.py:92",
        median_ms(lambda: O.rma_apply(win, r128, d, "sum"), torch),
        median_ms(lambda: O.rma_apply_plain(win, r128, d, "sum"), torch),
        median_ms(lambda: torch.add(view, r128, out=view), torch),
        3 * EMB_DIM * 4, EMB_DIM, record=False)
    # the batches at the embedding path's shapes: rank 0's update fence
    # (2048 distinct rows of 128, SUM) and one lookup fence's reads (512)
    target = O.Target(win)
    g = torch.Generator().manual_seed(74)
    ids = torch.randperm(EMB_ROWS, generator=g)[:EMB_UPDATES]
    grads = make(torch, EMB_UPDATES * EMB_DIM, torch.float32, 75, dev,
                 traps=False)
    upd = [(0, i * EMB_DIM, EMB_DIM, r * EMB_DIM, 1, "sum")
           for i, r in enumerate(ids.tolist())]
    w2, g2, idx = win.view(EMB_ROWS, EMB_DIM), grads.view(-1, EMB_DIM), \
        ids.to(dev)
    k8b = lambda: target.apply([grads], upd)  # noqa: E731
    lib8b = lambda: w2.index_add_(0, idx, g2)  # noqa: E731
    dev_ms = queued_ms(k8b, torch, 10)
    row("rma_apply_strided_batch", "ompi_tpu/osc/pallas_kernels.py:111",
        median_ms(k8b, torch),
        median_ms(lambda: O.rma_apply_strided_batch_plain(
            win, [(grads[o:o + k], dd, s, kind)
                  for _b, o, k, dd, s, kind in upd]), torch),
        median_ms(lib8b, torch), 3 * EMB_UPDATES * EMB_DIM * 4,
        EMB_UPDATES * EMB_DIM, device_ms=dev_ms)
    print(f"kernel rma_apply_strided_batch ({EMB_UPDATES} rows of {EMB_DIM}, "
          f"{-(-EMB_UPDATES // O.TABLE_CAP)} launches) queued (device only):"
          f" {dev_ms:.4f} ms, index_add_ "
          f"{queued_ms(lib8b, torch, 10):.4f} ms [{card}]", flush=True)
    look = ids[:EMB_LOOKUPS]
    outb = torch.empty(EMB_LOOKUPS * EMB_DIM, device=dev)
    reads = [(r * EMB_DIM, 1, EMB_DIM, i * EMB_DIM)
             for i, r in enumerate(look.tolist())]
    lidx, o2 = look.to(dev), outb.view(-1, EMB_DIM)
    k9b = lambda: target.read(reads, outb)  # noqa: E731
    lib9b = lambda: torch.index_select(w2, 0, lidx, out=o2)  # noqa: E731
    dev_ms = queued_ms(k9b, torch, 10)
    row("rma_read_batch", "ompi_tpu/osc/pallas_kernels.py:133",
        median_ms(k9b, torch),
        median_ms(lambda: O.rma_read_batch_plain(win, reads, outb), torch),
        median_ms(lib9b, torch), 2 * EMB_LOOKUPS * EMB_DIM * 4, 0,
        device_ms=dev_ms)
    print(f"kernel rma_read_batch ({EMB_LOOKUPS} rows of {EMB_DIM}, one "
          f"launch) queued (device only): {dev_ms:.4f} "
          f"ms, index_select {queued_ms(lib9b, torch, 10):.4f} ms [{card}]",
          flush=True)
    del win, r128, out, view, target, grads, w2, g2, idx, outb, o2, lidx
    torch.cuda.empty_cache()
    return rows


def rma_batch_checks(torch, O, dev, card, results):
    """Phase 2 for the grouped K8 and K9: each batch wrapper bitwise
    against the loop of the single plain versions, for float32, bfloat16
    and int32 x every kind, at the paths' shapes (the halo path's two
    columns of an 8192 x 8192 tile; the embedding update's 2048 rows of 128
    into a 2**20 x 128 shard and 2048 lookups, each more than one table)
    and at the edges: overlapping descriptors (cut into runs), clamped,
    dropped, wrapped and filled displacements, a stride past the window,
    k = 0, unaligned payloads and outputs, and a contiguous descriptor K7
    takes inside a batch."""
    tile, col, emb = HALO ** 2, HALO, EMB_ROWS * EMB_DIM
    kinds = list(O.KINDS)
    g = torch.Generator().manual_seed(76)
    ids = torch.randperm(EMB_ROWS, generator=g)[:EMB_UPDATES].tolist()
    dups = torch.randint(0, 64, (300,), generator=g).tolist()
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        big = make(torch, tile, dtype, 80, dev)
        shard = make(torch, emb, dtype, 81, dev)
        pays = make(torch, EMB_UPDATES * EMB_DIM + 1, dtype, 82, dev)
        cols = pays[1:]  # payloads at an odd offset: no 16-byte vectors
        wide = make(torch, O.K7_MIN, dtype, 83, dev)
        halo = [(cols[:col], 0, col, "put"),
                (cols[col:2 * col], col - 1, col, "sum"),
                (cols[:col], 0, col, "max"),  # overlaps the first
                (cols[col:2 * col], tile - 5, col, "min"),  # one lands
                (cols[:col], -3 * col - 2, col, "prod"),  # drops the first
                (cols[:7], 5, tile + 1, "sum"),  # a stride past the window
                (cols[:0], 9, col, "put"),  # k = 0
                (wide, 3, 1, "replace"),  # K7, inside the batch
                (cols[:col], 2, col, "sum")]
        upd = [(pays[i * EMB_DIM:(i + 1) * EMB_DIM], r * EMB_DIM, 1,
                kinds[i % len(kinds)]) for i, r in enumerate(ids)]
        edge = [(pays[:EMB_DIM], d, 1, kinds[i % len(kinds)])
                for i, d in enumerate((emb - 100, -3, -emb - 5, 1 << 40))]
        dup = [(cols[i * 37:i * 37 + EMB_DIM], r * 61, 1, kinds[i % 6])
               for i, r in enumerate(dups)]  # rows that overlap: many runs
        for name, w0, descs in (("halo", big, halo), ("update", shard, upd),
                                ("edges + overlaps", shard, edge + dup)):
            got, want = w0.clone(), w0.clone()
            O.rma_apply_strided_batch(got, descs)
            O.rma_apply_strided_batch_plain(want, descs)
            ok, err = compare(torch, got, want)
            if not ok:
                fail(f"rma_apply_strided_batch != plain ({dtype} {name}, "
                     f"{len(descs)} descriptors), err {err}")
            results["rma_apply_strided_batch"] = max(
                results["rma_apply_strided_batch"], err)
            del got, want
        rows = [(r * EMB_DIM, 1, EMB_DIM) for r in ids]
        odd = [(emb - 100, 1, EMB_DIM), (-3, 1, 5), (1 << 40, 1, 9),
               (-emb - 5, 1, 3), (-5, -3, 64), (7, 0, 32), (emb - 10, 3, 40),
               (-emb - 9, 2, 30), (0, 1, 0), (col - 2, col, 77)]
        for name, lst in (("rows, then edges", rows + odd),
                          ("edges, then rows (unaligned)", odd + rows)):
            descs, at = [], 0
            for dd, s, k in lst:
                descs.append((dd, s, k, at))
                at += k
            got = torch.zeros(at, dtype=dtype, device=dev)
            want = torch.zeros(at, dtype=dtype, device=dev)
            O.rma_read_batch(shard, descs, got)
            O.rma_read_batch_plain(shard, descs, want)
            ok, err = compare(torch, got, want)
            if not ok:
                fail(f"rma_read_batch != plain ({dtype} {name}, "
                     f"{len(descs)} descriptors), err {err}")
            results["rma_read_batch"] = max(results["rma_read_batch"], err)
            del got, want
        torch.cuda.synchronize()
        del big, shard, pays, cols, wide, halo, upd, edge, dup
        torch.cuda.empty_cache()
    print(f"kernels: K8 and K9 batches bitwise equal to the loops of their "
          f"single plain versions for float32/bfloat16/int32 x "
          f"{len(kinds)} kinds: the halo columns of a {HALO} x {HALO} tile, "
          f"{EMB_UPDATES} rows and lookups of {EMB_DIM} in a {EMB_ROWS} x "
          f"{EMB_DIM} shard (tables of {O.TABLE_CAP}), overlapping runs, "
          f"clamped, dropped, wrapped and filled edges, K7 inside a batch "
          f"[{card}]", flush=True)


def permute_batch_checks(torch, O, dev, card, results):
    """Phase 2 for the grouped K10 (rma_permute_recv_batch): every table
    bitwise against the loop of the single plain pulls, outputs poisoned,
    for float32, bfloat16 and int32: the 4-rank embedding lookup's
    exchange at one reader (a block from each owner's staged region,
    landed end to end), null sources (zeros) among real ones, spans whose
    source and output share no 16-byte offset (the element loop; one past
    STREAM_SMALL), odd lengths, zero-length spans, a table of more spans
    than one launch takes, and payloads carrying signalling-NaN, quiet-NaN
    and -0 bits."""
    per_src = EMB_LOOKUPS // N_RANKS * EMB_DIM
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        es = torch.empty(0, dtype=dtype).element_size()
        big = STREAM_SMALL // es + 5  # a span of four vectors a thread
        region = make(torch, 4 * big + 2 * N_RANKS * per_src + 16384, dtype,
                      77, dev)
        b = bits(torch, region)
        if dtype != torch.int32:  # signalling NaN and -0 bit patterns
            # (signalling NaN, the same with the sign bit, -0) as the
            # signed integers of their bits
            snan, nsnan, neg0 = (0x7F81, -0x7F, -(1 << 15)) if es == 2 \
                else (0x7F800001, -0x7FFFFF, -(1 << 31))
            b[11::257] = snan
            b[13::263] = neg0
            b[17::269] = nsnan

        def span(at, k):
            if at + k > region.numel():
                fail(f"K10 check span [{at}, {at + k}) past its region")
            return region[at:at + k]

        tables = {
            "lookup exchange": [(span(q * 2 * per_src, per_src), per_src, 0)
                                for q in range(N_RANKS)],
            "null sources": [(span(8, 4099), 4099, 0), (None, 77, 0),
                             (span(40, 128), 128, 4), (None, big, 1),
                             (span(3 * big, 33), 33, 0)],
            "no shared offset": [(span(1, 4099), 4099, 0),
                                 (span(3, big), big, 2),
                                 (span(2, 64), 64, 3)],
            "odd lengths": [(span(5 + 2 * k, k), k, k % 3)
                            for k in (1, 3, 7, 129, 4099, big)],
            "zero-length spans": [(span(0, 0), 0, 0), (span(16, 200), 200, 0),
                                  (None, 0, 0), (span(9, 0), 0, 1)],
            "more than one launch": [
                (None if j % 7 == 3 else span(97 * j, 61 + j), 61 + j, j % 4)
                for j in range(2 * O.COPY_CAP + 22)]}
        for name, spans in tables.items():
            if name == "lookup exchange":  # one landing tensor, end to end
                land = poisoned(torch, N_RANKS * per_src, dtype, 0, dev)
                pairs = [(src, land[q * per_src:(q + 1) * per_src])
                         for q, (src, _k, _o) in enumerate(spans)]
            else:
                pairs = [(src, poisoned(torch, k, dtype, off, dev))
                         for src, k, off in spans]
            want = []
            for src, out in pairs:
                w = torch.empty_like(out)
                O.rma_permute_recv_plain(src, w)
                want.append(w)
            O.rma_permute_recv_batch(pairs)
            for j, ((src, got), w) in enumerate(zip(pairs, want)):
                ok, err = compare(torch, got, w)
                if not ok:
                    fail(f"rma_permute_recv_batch != the single plain pulls "
                         f"({dtype} {name}, span {j} of {len(pairs)}), err "
                         f"{err}")
                results["rma_permute_recv_batch"] = max(
                    results["rma_permute_recv_batch"], err)
        torch.cuda.synchronize()
        del region, b, tables, pairs, want
    print(f"kernels: K10's grouped launch bitwise equal to the loop of its "
          f"single plain pulls for float32/bfloat16/int32, outputs "
          f"poisoned: the lookup exchange ({N_RANKS} blocks of {per_src} "
          f"elements), null sources, spans with no shared 16-byte offset, "
          f"odd lengths, zero-length spans, {2 * O.COPY_CAP + 22} spans "
          f"(tables of {O.COPY_CAP}), signalling-NaN and -0 bits [{card}]",
          flush=True)


def smoke_dir(root: str, example: str, nranks: int,
              component: str | None = "coll_cuda", tag: str = "") -> str:
    """Where :func:`main_path` has the ranks of a job write their JSON."""
    name = os.path.splitext(example)[0]
    return os.path.join(root, "build", "ompi_tpu_torch",
                        f"smoke_{name}{tag}_{component or 'device'}_"
                        f"n{nranks}")


def main_path(example: str, nranks: int, args, card: str, root: str,
              component: str | None = "coll_cuda", extra_mca=(),
              tag: str = ""):
    """Phase 3: one launcher job of an example under ``--mca
    device_plane on --mca <component> on`` (None: the device plane
    alone, so coll/device serves) and ``extra_mca``; returns the ranks'
    summed launches and rank 0's report. Every kernel a rank reports must
    have launched, or, where its report names them (``required``), those.
    No rank may have staged a call through the host
    (``coll_accelerator_staged``)."""
    name = os.path.splitext(example)[0]
    out = smoke_dir(root, example, nranks, component, tag)
    shutil.rmtree(out, ignore_errors=True)
    mca = (["--mca", component, "on"] if component else []) \
        + list(extra_mca)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
           "-n", str(nranks), "--timeout", str(LAUNCH_TIMEOUT),
           "--mca", "device_plane", "on", *mca,
           os.path.join(root, "ompi_tpu_torch", "examples", example),
           *args, "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT + 30)
    wall = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"{line} [{card}]", flush=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"{name}: {nranks}-rank launcher job exited {proc.returncode}")
    launches: dict = {}
    docs = []
    for r in range(nranks):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            doc = json.load(f)
        docs.append(doc)
        bad = [c for c in doc["cases"] if not c["ok"]]
        if bad:
            fail(f"{name}: rank {r} of {nranks}: mismatches {bad}")
        if not doc["device"].startswith("cuda"):
            fail(f"{name}: rank {r} ran on {doc['device']}")
        if doc["coll_accelerator_staged"] != 0:
            fail(f"{name}: rank {r} of {nranks} staged "
                 f"{doc['coll_accelerator_staged']} calls through the host "
                 "on a kernel path")
        for k, v in doc["launches"].items():
            launches[k] = launches.get(k, 0) + v
    need = docs[0].get("required", list(launches))
    if not need or any(launches.get(k, 0) <= 0 for k in need):
        fail(f"{name} n={nranks}: a kernel of the path never launched: "
             f"{launches} (required {need})")
    print(f"main path {name} n={nranks} {component or 'device plane alone'}"
          f": {wall:.1f} s wall, kernel launches (all ranks) {launches}, "
          f"required {need} [{card}]", flush=True)
    return launches, docs[0]


def host_collectives_report(doc4, doc8, card: str) -> None:
    """The host baselines beside coll/device's calls of the same size
    (rank 0's p50): BASELINE config 3's 4-rank Allreduce sweep under
    coll/tuned's default decision and each forced algorithm at 1 MiB,
    config 2's 8-rank Bcast, and the staged calls. Every case must be
    there (the ranks checked each one's result)."""
    def cases(doc, kind, mode=None):
        return [c for c in doc["cases"] if c["kind"] == kind
                and (mode is None or c.get("mode") == mode)]

    sizes = [int(t.rstrip("km")) << {"k": 10, "m": 20}[t[-1]]
             for t in HOST_SIZES.split(",")]
    host = {c["bytes"]: c for c in cases(doc4, "host Allreduce",
                                         "tuned default")
            if c["dtype"] == "float32"}
    dev = {c["bytes"]: c for c in cases(doc4,
                                        "device Allreduce beside host")}
    if not all(b in host and b in dev for b in sizes):
        fail(f"the host Allreduce sweep lacks sizes: host {sorted(host)}, "
             f"device {sorted(dev)}")
    for b in sizes:
        h, d = host[b], dev[b]
        print(f"config 3 host baseline n={N_RANKS} float32 SUM Allreduce "
              f"{b} B: coll/tuned default p50 {h['p50_ms']:.4f} ms (bus "
              f"{h['busbw_GBps']:.3f} GB/s), coll/device CUDA tensor p50 "
              f"{d['p50_ms']:.4f} ms (bus {d['busbw_GBps']:.3f} GB/s), "
              f"host/device {h['p50_ms'] / d['p50_ms']:.2f}x [{card}]",
              flush=True)
    forced = cases(doc4, "host Allreduce by algorithm")
    if len(forced) != 10:
        fail(f"the forced-algorithm host Allreduces: {forced}")
    print(f"config 3 host Allreduce n={N_RANKS} 1 MiB by coll/tuned "
          "algorithm (p50 ms): " + ", ".join(
              f"{c['dtype']} {c['mode'][len('tuned '):]} {c['p50_ms']:.4f}"
              for c in forced) + f" [{card}]", flush=True)
    for root in (0, BCAST_RANKS - 1):
        got = {c["mode"]: c for c in cases(doc8, f"host Bcast root={root}")}
        dv = cases(doc8, f"device Bcast root={root} beside host")
        if set(got) != {"tuned default", "tuned linear"} or len(dv) != 1:
            fail(f"the 8-rank host Bcast from root {root}: {got}, {dv}")
        print(f"config 2 host baseline n={BCAST_RANKS} float32 Bcast 1 MiB "
              f"root {root}: coll/tuned binomial p50 "
              f"{got['tuned default']['p50_ms']:.4f} ms, linear "
              f"{got['tuned linear']['p50_ms']:.4f} ms, coll/device CUDA "
              f"tensor {dv[0]['p50_ms']:.4f} ms [{card}]", flush=True)
    staged = [c for c in doc4["cases"] if c["kind"].startswith("staged")
              or c["kind"].startswith("coll_accelerator_staged")]
    if len(staged) != 5:
        fail(f"the staged calls: {staged}")
    print("staged through coll/accelerator n=4 (rank 0): " + ", ".join(
        f"{c['kind']} {c['bytes']} B p50 {c['p50_ms']:.4f} ms"
        if "p50_ms" in c else c["kind"] for c in staged) + f" [{card}]",
          flush=True)


def osc_report(name: str, nranks: int, doc, card: str) -> None:
    """The one-sided path's fence times, the reference's rounds and the
    exchanges that moved them (rank 0)."""
    ms = doc["fence_ms"]
    ms = ms.items() if isinstance(ms, dict) else enumerate(ms)
    print(f"one-sided path {name} n={nranks} (rank 0): fence ms "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms)
          + f"; rounds {doc['rounds']}; exchanges {doc['exchanges']} "
          f"[{card}]", flush=True)


#: phase 7's parts and the kernels each must launch (context_parallel.py)
CP_PARTS = {"collectives": ("ring_rs_hop", "ring_ag_hop", "linear_fold"),
            "attention": ("ring_ag_hop",), "moe": ("ring_ag_hop",)}


def context_parallel_phase(card: str, root: str) -> dict:
    """Phase 7: ``context_parallel.py`` on 4 ranks under the device plane
    alone (coll/device serves the axis collectives). Every rank's checks
    must hold, each part must have launched its kernels (summed over the
    ranks), and no rank may have staged a call or sent a point-to-point
    tensor through the host. Prints rank 0's times; returns the
    launches."""
    t0 = time.perf_counter()
    launches, doc = main_path("context_parallel.py", N_RANKS, [], card,
                              root, None)
    out = os.path.join(root, "build", "ompi_tpu_torch",
                       f"smoke_context_parallel_device_n{N_RANKS}")
    parts: dict = {}
    for r in range(N_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            d = json.load(f)
        if d["accel_p2p_send"] or d["accel_p2p_recv"]:
            fail(f"context_parallel rank {r} sent tensors point to point "
                 f"through the host: {d['accel_p2p_send']} sends, "
                 f"{d['accel_p2p_recv']} receives")
        for part, got in d["part_launches"].items():
            acc = parts.setdefault(part, {})
            for k, v in got.items():
                acc[k] = acc.get(k, 0) + v
    missing = [(p, k) for p, ks in CP_PARTS.items() for k in ks
               if parts.get(p, {}).get(k, 0) <= 0]
    if missing:
        fail(f"context_parallel: kernels never launched in a part: "
             f"{missing} ({parts})")
    t, m = doc["times"], doc["moe"]
    print(f"phase 7 context_parallel n={N_RANKS} (rank 0 p50 of "
          f"{len(t['ring_attention'][1])} ms): ring_attention "
          f"{t['ring_attention'][0]:.3f} (its compute alone "
          f"{t['ring_attention_compute'][0]:.3f}), ulysses_attention "
          f"{t['ulysses_attention'][0]:.3f}, mha whole sequence (rank 0 "
          f"alone) {t['mha_whole_sequence'][0]:.3f} (mha_auto, PyTorch's "
          f"SDPA, {t['mha_auto_whole_sequence'][0]:.3f}), permute_dev hop of "
          f"(k, v) {t['permute_hop_kv_bytes']} B "
          f"{t['permute_hop_kv'][0]:.3f}, moe_ffn {t['moe_ffn'][0]:.3f}, "
          f"its two Alltoalls ({m['alltoall_bytes']} B each) "
          f"{t['moe_alltoalls'][0]:.3f}; moe dropped {m['dropped']} of "
          f"{m['tokens']} tokens (rank 0), per-expert counts "
          f"{m['counts']}; launches per part (all ranks) {parts}; "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]", flush=True)
    return launches


#: phase 8's parts and the kernels each must launch (transformer_training.py)
MODEL_PARTS = {"tp_sp": ("ring_rs_hop", "ring_ag_hop"),
               "pp": ("ring_ag_hop",)}
ORACLE_TIMEOUT = 300  # seconds for phase 8's one-rank oracle


def model_phase(card: str, root: str) -> dict:
    """Phase 8: ``transformer_training.py`` on 4 ranks under the device
    plane alone, then its one-rank oracle in a process of its own. Every
    rank's checks must hold, each part must have launched its kernels
    (summed over the ranks) and the oracle must accept the job's loss and
    gradients. Prints the parts' and the oracle's times, rates and peak
    memory; returns the job's launches."""
    t0 = time.perf_counter()
    launches, doc = main_path("transformer_training.py", N_RANKS, [], card,
                              root, None)
    out = os.path.join(root, "build", "ompi_tpu_torch",
                       f"smoke_transformer_training_device_n{N_RANKS}")
    parts: dict = {}
    peaks: dict = {}
    for r in range(N_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            d = json.load(f)
        for part, got in d["parts"].items():
            acc = parts.setdefault(part, {})
            for k, v in got["launches"].items():
                acc[k] = acc.get(k, 0) + v
            peaks.setdefault(part, []).append(got["peak_bytes"])
        peaks.setdefault("arenas", []).append(d["arena_bytes"])
    missing = [(p, k) for p, ks in MODEL_PARTS.items() for k in ks
               if parts.get(p, {}).get(k, 0) <= 0]
    if missing:
        fail(f"transformer_training: kernels never launched in a part: "
             f"{missing} ({parts})")
    job_s = time.perf_counter() - t0
    proc = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.examples.transformer_training",
         "--oracle", "--out", out], cwd=root, capture_output=True,
        text=True, timeout=ORACLE_TIMEOUT)
    for line in proc.stdout.splitlines():
        print(f"{line} [{card}]", flush=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"transformer_training: the one-rank oracle exited "
             f"{proc.returncode} (a loss or gradient outside its bound?)")
    with open(os.path.join(out, "oracle.json")) as f:
        oracle = json.load(f)
    for name, part in doc["parts"].items():
        o = oracle["parts"][name]
        gib = [round(b / 2 ** 30, 3) for b in peaks[name]]
        print(f"phase 8 {name} n={N_RANKS} mesh {part['mesh']} L"
              f"{part['layers']} ({part['params']} params): rank 0 step p50 "
              f"{part['p50_ms']:.1f} ms of "
              f"{[round(v, 1) for v in part['step_ms']]} (warm "
              f"{part['warm_ms']:.1f}), {part['tokens_per_s']:.1f} tokens/s,"
              f" {part['tflops']:.2f} TFLOP/s; peak memory per rank {gib} "
              f"GiB; launches (all ranks) {parts[name]}; one-rank oracle "
              f"step p50 {o['p50_ms']:.1f} ms of "
              f"{[round(v, 1) for v in o['step_ms']]} (warm "
              f"{o['warm_ms']:.1f}), {o['tokens_per_s']:.1f} tokens/s, "
              f"{o['tflops']:.2f} TFLOP/s, peak "
              f"{o['peak_bytes'] / 2 ** 30:.3f} GiB; first loss job "
              f"{part['first_loss']:.6f} oracle {o['first_loss']:.6f} (rel "
              f"err {o['loss_rel_err']:.2e}), gradients' max rel err "
              f"{o['grad_rel_err_max']:.2e} [{card}]", flush=True)
    print(f"phase 8 arenas per rank (the largest comm's, bytes) "
          f"{peaks['arenas']}; job {job_s:.1f} s, with the oracle "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]", flush=True)
    return launches


#: the AM phase's parts, in the order osc_passive.py runs them
AM_PARTS = ("pscw halo", "passive embedding", "atomics")


def am_phase(card: str, root: str) -> dict:
    """Phase 6: PSCW and passive-target epochs on device windows
    (``osc_passive.py`` on 4 ranks under ``--mca osc_cuda on``): the K7 /
    K8 / K9 launches of every part, summed over the ranks, must equal
    what the ranks derived from their schedules (each rank asserts its
    own), and each part's epoch times (rank 0's p50 of 3), AM messages
    and the per-message split are printed. Returns the launches."""
    launches, doc = main_path("osc_passive.py", N_RANKS, [], card, root,
                              "osc_cuda")
    out = os.path.join(root, "build", "ompi_tpu_torch",
                       f"smoke_osc_passive_osc_cuda_n{N_RANKS}")
    docs = []
    for r in range(N_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    for part in AM_PARTS:
        got = {k: sum(d["part_launches"][part][k] for d in docs)
               for k in docs[0]["part_launches"][part]}
        want = {k: sum(d["part_expected"][part][k] for d in docs)
                for k in got}
        if got != want:
            fail(f"AM phase {part}: launches {got}, scheduled {want}")
        print(f"AM phase {part} n={N_RANKS}: K7 rma_apply {got['rma_apply']}"
              f", K8 rma_apply_strided {got['rma_apply_strided']}, K9 "
              f"rma_read {got['rma_read']} launches (all ranks), as "
              f"scheduled [{card}]", flush=True)
    rep = doc["report"]

    def p50(xs):
        return sorted(xs)[len(xs) // 2]

    h = rep["pscw_halo"]
    print(f"AM phase PSCW halo n={N_RANKS} {HALO} x {HALO} float32 (rank 0):"
          f" epoch p50 {p50(h['epoch_ms']):.3f} ms of {h['epoch_ms']}, "
          f"{h['messages']} AM messages sent a step; the same puts in "
          f"fence epochs p50 {p50(h['fence_ms']):.3f} ms of {h['fence_ms']}"
          f" [{card}]", flush=True)
    e = rep["passive_embedding"]
    print(f"AM phase passive target n={N_RANKS} {EMB_ROWS} x {EMB_DIM} "
          f"float32 (rank 0): update epoch (Lock_all, 512 Accumulate rows, "
          f"Flush_all) p50 {p50(e['update_ms']):.3f} ms of {e['update_ms']}"
          f", {e['update_messages']} AM messages sent; 512 row Gets p50 "
          f"{p50(e['lookup_ms']):.3f} ms of {e['lookup_ms']}, "
          f"{e['lookup_messages']} messages [{card}]", flush=True)
    sp = rep["split"]
    print(f"AM phase per-message split at rank 0 (a {EMB_DIM}-float "
          f"Accumulate row, measured alone): receive and unpickle "
          f"{sp['receive_unpickle_us']:.2f} us, H2D {sp['h2d_us']:.2f} us, "
          f"K7 launch {sp['launch_us']:.2f} us; origin D2H "
          f"{sp['origin_d2h_us']:.2f} us, object send "
          f"{sp['origin_send_us']:.2f} us; the update epoch "
          f"{sp['update_epoch_us_per_row']:.2f} us per row sent [{card}]",
          flush=True)
    a = rep["atomics"]
    print(f"AM phase atomics n={N_RANKS} (rank 0): epoch (Lock_all, 64 "
          f"Fetch_and_op a rank into rank 0, a CAS ring, a NO_OP "
          f"Get_accumulate, a BAND Accumulate) p50 {p50(a['epoch_ms']):.3f} "
          f"ms of {a['epoch_ms']}, {a['messages']} AM messages sent "
          f"[{card}]", flush=True)
    return launches


#: phase 9's parts and the kernels each must launch (device_epoch.py)
DE_PARTS = {"embedding": ("rma_apply_strided_batch", "rma_read_batch",
                          "rma_permute_recv_batch"),
            "block": ("rma_apply", "rma_read_batch", "rma_permute_recv_batch")}


def device_epoch_phase(card: str, root: str) -> dict:
    """Phase 9: ``device_epoch.py`` on 4 ranks under the device plane
    alone. Every rank's checks must hold (each epoch bitwise against the
    CudaWindow's and the numpy replay, the IPC round trip, the pvars, its
    launches as derived); each part's launches, summed over the ranks,
    must equal what the ranks derived and include the part's kernels.
    Prints rank 0's epoch times beside the CudaWindow's, part 2's rate,
    the rounds and exchanges, and every rank's peak memory and arena
    bytes; returns the device-epoch windows' launches."""
    t0 = time.perf_counter()
    launches, doc = main_path("device_epoch.py", N_RANKS, [], card, root,
                              None)
    out = os.path.join(root, "build", "ompi_tpu_torch",
                       f"smoke_device_epoch_device_n{N_RANKS}")
    docs = []
    for r in range(N_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    for part, need in DE_PARTS.items():
        got, cw, want = ({k: sum(d[key][part][k] for d in docs)
                          for k in docs[0][key][part]}
                         for key in ("part_launches", "part_cuda_window",
                                     "part_expected"))
        if got != want or cw != want or any(got[k] <= 0 for k in need):
            fail(f"phase 9 {part}: device-epoch launches {got}, CudaWindow "
                 f"{cw}, derived {want} (must launch {need})")
        print(f"phase 9 {part} n={N_RANKS}: launches (all ranks) {got}, "
              f"as derived, the CudaWindow's the same [{card}]", flush=True)
    rep = doc["report"]
    e, b, i = rep["embedding"], rep["block"], rep["ipc"]

    def p50(xs):
        return sorted(xs)[len(xs) // 2]

    print(f"phase 9 embedding n={N_RANKS} {e['rows']} x {e['dim']} float32 "
          f"(rank 0): SUM epoch ({e['batch']} Gets + {e['batch']} "
          f"Accumulate rows a rank) p50 {p50(e['epoch_ms']):.3f} ms of "
          f"{[round(v, 3) for v in e['epoch_ms']]}, CudaWindow's "
          f"{p50(e['cuda_window_ms']):.3f} of "
          f"{[round(v, 3) for v in e['cuda_window_ms']]}; (rounds, "
          f"exchanges) per epoch {e['rounds_exchanges']} [{card}]",
          flush=True)
    print(f"phase 9 block n={N_RANKS} {b['elements']} float32 a rank "
          f"(rank 0): epoch p50 {p50(b['epoch_ms']):.3f} ms of "
          f"{[round(v, 3) for v in b['epoch_ms']]}, "
          f"{b['gbps_per_rank']:.1f} GB/s a rank (a block out, a block "
          f"in), CudaWindow's {p50(b['cuda_window_ms']):.3f} of "
          f"{[round(v, 3) for v in b['cuda_window_ms']]}; (rounds, "
          f"exchanges) {b['rounds_exchanges']} [{card}]", flush=True)
    print(f"phase 9 IPC {i['bytes']} B: export (rank 0) "
          f"{i['ms']['export']:.3f} ms, import onto rank 1's card "
          f"{i['ms']['import']:.3f} ms; peak allocated per rank "
          f"{[round(d['report']['peak_bytes'] / 2 ** 30, 3) for d in docs]}"
          f" GiB, device_plane_arena_bytes "
          f"{[d['report']['arena_bytes'] for d in docs]}; "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]", flush=True)
    return launches


#: phase 10's two-level jobs: coll/hier over a forced 2 x 2 grid, its
#: ICI phases on coll/cuda's ring
HIER_MCA = ("--mca", "coll_hier", "on", "--mca", "coll_hier_split", "2x2",
            "--mca", "coll_hier_inner", "ring")
#: phase 10 part 3's wire formats (zero_training.py --error-feedback)
EF_WIRES = "bf16,fp8_e4m3"


#: phase 11 (moe_serving.py): the jobs' mca, the widths' bytes of expert
#: weights on the card (4 ranks x 4 experts x 2 x 7168 x 28672 float32)
SERVE_MCA = ("--mca", "monitoring_level", "1")
SERVE_JOBS = (("_serve", ["--width", "full", "--parts",
                          "drop,reroute,monitoring"], SERVE_MCA),
              ("_serve_dcn", ["--width", "full", "--parts", "dcn_overflow"],
               SERVE_MCA + ("--mca", "coll_hier_split", "2x2")))
SERVE_WEIGHT_BYTES = N_RANKS * 4 * 2 * 7168 * 28672 * 4


def rank_docs(out: str, nranks: int) -> list:
    docs = []
    for r in range(nranks):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            docs.append(json.load(f))
    return docs


def hier_phase(card: str, root: str) -> dict:
    """Phase 10: the hierarchy layer, three 4-rank jobs under ``--mca
    device_plane on --mca coll_cuda on`` (parts 1 and 2 also under
    :data:`HIER_MCA`): ``hier_collectives.py`` (the two-level
    collectives at full size beside the flat ones), ``hier_dcn_compress.py``
    (the wire formats at 256 MiB) and ``zero_training.py --error-feedback``
    (the error-feedback ZeRO step at GPT-2 small's width, flat). Every
    rank's checks must hold; each part's K1-K3 launches, summed over the
    ranks, must equal what the ranks derived from their schedules, with K1
    and K2 launched in part 1 and K3 in its 'linear' calls. Prints rank
    0's times, the per-level bytes, the wire rows, the EF step times and
    every rank's peak memory and arena bytes; returns the launches."""
    t0 = time.perf_counter()
    total: dict = {}
    jobs = (("hier_collectives.py", [], HIER_MCA),
            ("hier_dcn_compress.py", [], HIER_MCA),
            ("zero_training.py", ["--error-feedback", EF_WIRES], ()))
    docs = {}
    for example, args, mca in jobs:
        got, _ = main_path(example, N_RANKS, args, card, root, "coll_cuda",
                           mca, tag="_hier")
        docs[example] = rank_docs(smoke_dir(root, example, N_RANKS,
                                            tag="_hier"), N_RANKS)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
    # part 1: every part's launches as derived, summed over the ranks
    d1 = docs["hier_collectives.py"]
    for part in d1[0]["parts"]:
        got = {k: sum(d["parts"][part]["got"][k] for d in d1)
               for k in d1[0]["parts"][part]["got"]}
        want = {k: sum(d["parts"][part]["want"][k] for d in d1)
                for k in got}
        if got != want:
            fail(f"phase 10 hier_collectives {part}: launches {got}, "
                 f"derived {want}")
        print(f"phase 10 hier_collectives {part} n={N_RANKS}: launches "
              f"(all ranks) {got}, as derived [{card}]", flush=True)
    k1 = sum(d["launches"]["ring_rs_hop"] for d in d1)
    k2 = sum(d["launches"]["ring_ag_hop"] for d in d1)
    k3 = sum(d["parts"]["allreduce"]["got"]["linear_fold"] for d in d1)
    if not (k1 > 0 and k2 > 0 and k3 > 0):
        fail(f"phase 10 part 1: K1 {k1}, K2 {k2}, K3 in 'linear' {k3}")
    for label, t in d1[0]["times"].items():
        if "hier_p50" in t:
            print(f"phase 10 allreduce {label} n={N_RANKS} 2x2 (rank 0 p50 "
                  f"of {len(t['hier'])}): two-level {t['hier_p50']:.3f} ms "
                  f"of {[round(v, 3) for v in t['hier']]}, flat coll/cuda "
                  f"({t['flat_algo']}) {t['flat_p50']:.3f} ms of "
                  f"{[round(v, 3) for v in t['flat']]}; per-level bytes ICI "
                  f"{t['ici_bytes']} DCN {t['dcn_bytes']} [{card}]",
                  flush=True)
    m = d1[0]["times"]["allreduce_multi"]
    print(f"phase 10 allreduce_multi 'linear' n={N_RANKS} over "
          f"{m['leaves']} leaves ({m['elements']} float32, {m['buckets']} "
          f"buckets), rank 0: two-level {m['hier_ms']:.3f} ms, flat fused "
          f"{m['flat_ms']:.3f} ms [{card}]", flush=True)
    # part 2: the wire rows
    d2 = docs["hier_dcn_compress.py"]
    got = {k: sum(d["launches"][k] for d in d2) for k in d2[0]["launches"]}
    want = {k: sum(d["expected"][k] for d in d2) for k in got}
    if got != want:
        fail(f"phase 10 hier_dcn_compress: launches {got}, derived {want}")
    for wire, row in d2[0]["wires"].items():
        extra = (f", DCN wire {row['wire_bytes']} of {row['nominal']} B "
                 f"nominal ({row['ratio']:.4f}), worst element error "
                 f"{row['worst_eps_units']:.4f} eps of the exact value, max "
                 f"abs {row['max_abs_err']:.6g}") if "ratio" in row else ""
        print(f"phase 10 wire {wire} n={N_RANKS} {d2[0]['bytes']} B float32 "
              f"(rank 0 p50 of {len(row['ms'])}): {row['p50_ms']:.3f} ms of "
              f"{[round(v, 3) for v in row['ms']]}{extra} [{card}]",
              flush=True)
    # part 3: the error-feedback step
    d3 = docs["zero_training.py"]
    ef = d3[0]["error_feedback"]
    for wire in EF_WIRES.split(","):
        print(f"phase 10 error-feedback {wire} n={N_RANKS} GPT-2 small "
              f"({d3[0]['parameters']} float32, {d3[0]['buckets']} buckets)"
              f": step p50 {ef[wire]['p50_ms']:.3f} ms of "
              f"{[round(v, 3) for v in ef[wire]['ms']]}, exact "
              f"{ef['exact']['p50_ms']:.3f} ms of "
              f"{[round(v, 3) for v in ef['exact']['ms']]}; losses "
              f"{ef[wire]['loss']} vs exact {ef['exact']['loss']}; "
              f"zero_ef_bytes {ef[wire]['zero_ef_bytes']} [{card}]",
              flush=True)
    print(f"phase 10 peak allocated per rank (GiB) part 1 "
          f"{[round(d['peak_bytes'] / 2 ** 30, 3) for d in d1]}, part 2 "
          f"{[round(d['peak_bytes'] / 2 ** 30, 3) for d in d2]}; "
          f"device_plane_arena_bytes part 1 "
          f"{[d['device_plane_arena_bytes'] for d in d1]}, part 2 "
          f"{[d['arena_bytes'] for d in d2]}; arena bytes per comm (rank 0) "
          f"{d1[0]['arena_bytes']}; launches (all ranks) {total}; "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]", flush=True)
    return total


def serve_phase(card: str, root: str) -> dict:
    """Phase 11: the serving plane at full width, two 4-rank jobs of
    ``moe_serving.py`` under the device plane alone (coll/device's
    Alltoalls, K2) and ``monitoring_level 1`` (:data:`SERVE_JOBS`).
    Every rank's checks must hold (main_path), and each policy's K2
    launches, summed over the ranks, must equal the derived count.
    Prints rank 0's tail latencies and rates per policy beside the HBM
    floor, the serve pvars, the plane's collective records, the oracle
    and budget rows and every rank's peak memory; returns the launches."""
    t0 = time.perf_counter()
    total: dict = {}
    floor_ms = SERVE_WEIGHT_BYTES / HBM_BYTES_PER_S * 1e3
    for tag, args, mca in SERVE_JOBS:
        got, _ = main_path("moe_serving.py", N_RANKS, args, card, root, None,
                           mca, tag=tag)
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        docs = rank_docs(smoke_dir(root, "moe_serving.py", N_RANKS, None,
                                   tag), N_RANKS)
        for name, part in docs[0]["parts"].items():
            res = part.get("summary")
            if res is None:
                continue
            k2 = sum(d["parts"][name]["k2"]["got"] for d in docs)
            want = sum(d["parts"][name]["k2"]["derived"] for d in docs)
            if k2 != want or k2 <= 0:
                fail(f"phase 11 {name}: K2 launches {k2}, derived {want}")
            print(f"phase 11 {name} n={N_RANKS} d_model 7168 d_ff 28672 "
                  f"(rank 0, {res['requests']} timed requests of 32 tokens):"
                  f" p50 {res['p50_ms']:.3f} ms, p95 {res['p95_ms']:.3f} ms, "
                  f"p99 {res['p99_ms']:.3f} ms, {res['tokens_per_s']:.1f} "
                  f"tokens/s (HBM floor {floor_ms:.3f} ms a request: "
                  f"{SERVE_WEIGHT_BYTES} B of experts at 3.35 TB/s); drop "
                  f"rate {res['drop_rate']:.4f}, rerouted {res['rerouted']}, "
                  f"DCN {res['dcn_tokens']} tokens {res['dcn_bytes']} B, hot "
                  f"expert e{res['hot_expert']} ({res['hot_share']:.3f}); "
                  f"serve pvars {part['pvars']}; K2 launches (all ranks) "
                  f"{k2}, as derived [{card}]", flush=True)
        for name, part in docs[0]["parts"].items():
            if name.startswith("report"):
                print(f"phase 11 {name}: {part['hot_line']} named; the "
                      f"plane's collective records {part['coll_records']}; "
                      f"per-level {part['hier_levels']} [{card}]", flush=True)
        mon = docs[0]["parts"].get("monitoring")
        if mon is not None:  # phase 17 C: the monitoring plane's cost
            k2 = sum(d["parts"]["monitoring"]["k2"]["got"] for d in docs)
            want = sum(d["parts"]["monitoring"]["k2"]["derived"]
                       for d in docs)
            if k2 != want:
                fail(f"phase 11 monitoring: K2 launches {k2}, derived "
                     f"{want}")
            lv = mon["levels"]
            base = lv["0"]["p50_ms"]

            def q(ms):
                ms = sorted(ms)
                return " / ".join(f"{ms[i * len(ms) // 4]:.3f}"
                                  for i in (1, 2, 3))
            print(f"phase 17 C (in phase 11's drop job) the monitoring "
                  f"plane on the drop decode n={N_RANKS} (rank 0, "
                  f"{len(lv['0']['ms'])} requests a level in turns; p25 / "
                  f"p50 / p75 ms): "
                  + ", ".join(f"level {k} {q(v['ms'])} "
                              f"({(v['p50_ms'] / base - 1) * 100:+.1f}%)"
                              for k, v in sorted(lv.items()))
                  + f"; outputs bitwise at every level; K2 {k2} as "
                  f"derived [{card}]", flush=True)
        dcn = docs[0]["parts"].get("dcn_overflow")
        if dcn is not None:
            errs = [d["parts"]["dcn_overflow"]["oracle"] for d in docs]
            print(f"phase 11 dcn_overflow oracle (float64, per rank): max "
                  f"|out - oracle| {[e['max_abs_err'] for e in errs]} of max "
                  f"|oracle| {[e['max_abs_oracle'] for e in errs]}; budget "
                  f"(rank 0) {dcn['budget']} [{card}]", flush=True)
        print(f"phase 11{tag} peak allocated per rank (GiB) "
              f"{[round(d['peak_bytes'] / 2 ** 30, 3) for d in docs]} "
              f"[{card}]", flush=True)
    print(f"phase 11: launches (all ranks) {total}; "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]", flush=True)
    return total


#: phase 12's job (tools_plane.py): pml/v, the indexed matching engine,
#: device windows, and 1 MiB ring tensors cut into 4 chunks
TOOLS_MCA = ("--mca", "osc_cuda", "on", "--mca", "pml_v", "1", "--mca",
             "pml_ob1_matching", "indexed", "--mca",
             "pml_accel_chunk_bytes", str(256 << 10))


def tools_phase(card: str, root: str) -> dict:
    """Phase 12: the tools plane on the card, one 4-rank job of
    ``tools_plane.py`` (:data:`TOOLS_MCA`, coll/cuda on). Every rank's
    checks must hold (main_path), and each rank's K7-K10 launches must
    equal what it derived. Prints rank 0's ring and fence p50 with no
    handle and with every handle, the ring's event counts and the job's
    wall; returns the launches."""
    t0 = time.perf_counter()
    launches, doc = main_path("tools_plane.py", N_RANKS, [], card, root,
                              "coll_cuda", TOOLS_MCA)
    docs = rank_docs(smoke_dir(root, "tools_plane.py", N_RANKS), N_RANKS)
    for r, d in enumerate(docs):
        if d["launches"] != d["expected_launches"]:
            fail(f"phase 12 rank {r}: K7-K10 launches {d['launches']}, "
                 f"derived {d['expected_launches']}")
    rep = doc["report"]
    p50, times = rep["p50_ms"], rep["times_ms"]
    for part, what in (("ring", f"device ring {rep['ring_bytes']} B float32 "
                                "(Isend + Recv + wait)"),
                       ("fence", "CudaWindow fence epoch (2**20 + 4096 "
                                 "put, 4096 Get_epoch)")):
        off, on = p50[part]["off"], p50[part]["on"]
        print(f"phase 12 {what} n={N_RANKS} (rank 0 p50 of "
              f"{len(times[part]['off'])} in turns): no handle {off:.3f} "
              f"ms of {[round(v, 3) for v in times[part]['off']]}, every "
              f"handle {on:.3f} ms of "
              f"{[round(v, 3) for v in times[part]['on']]} "
              f"({(on / off - 1) * 100:+.1f}%) [{card}]", flush=True)
    print(f"phase 12: a site with no listener, ns a guard on rank 0's "
          f"host: {rep['guard_ns']} [{card}]", flush=True)
    print(f"phase 12: ring events per tensor {rep['ring_counts']}; "
          f"{rep['event_types']} MPI_T event types; K7-K10 launches (all "
          f"ranks) {launches}, as derived; "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]", flush=True)
    return launches


#: phase 13's jobs (sessions.py): coll/cuda and osc/cuda on; the Abort
#: job's rank, code and time limit
SESSION_MCA = ("--mca", "osc_cuda", "on")
ABORT_RANK, ABORT_CODE, ABORT_LIMIT = 2, 7, 60


def sessions_phase(card: str, root: str, world_doc) -> dict:
    """Phase 13: the sessions plane on the card. The session job's every
    check must hold (main_path: Is_initialized stays False, the grant,
    the query, the Allreduces bitwise, the recoveries, the fence replay,
    the fuzz schedule, the finalize and the second session), and each
    rank's K1-K3 and K7-K10 launches must equal what it derived. Prints
    the session comm's 256 MiB float32 Allreduce p50 ('ring', 'linear',
    timed in turns) beside COMM_WORLD's from ``world_doc`` (phase 3's
    4-rank coll/cuda collectives job), the grant, the recoveries and the
    launches; then runs the Abort job. Returns the launches."""
    t0 = time.perf_counter()
    launches, doc = main_path("sessions.py", N_RANKS, ["--device"], card,
                              root, "coll_cuda", SESSION_MCA)
    docs = rank_docs(smoke_dir(root, "sessions.py", N_RANKS), N_RANKS)
    for r, d in enumerate(docs):
        if d["launches"] != d["expected_launches"]:
            fail(f"phase 13 rank {r}: launches {d['launches']}, derived "
                 f"{d['expected_launches']}")
    rep = doc["report"]
    if rep["grant"] != "system,mpi,cuda,cuda:device" \
            or rep["query_cuda_support"] is not True:
        fail(f"phase 13: grant {rep['grant']!r}, MPIX_Query_cuda_support "
             f"{rep['query_cuda_support']}")
    world = {c["mode"]: c["p50_ms"] for c in world_doc["cases"]
             if c.get("kind") == "Allreduce" and c.get("dtype") == "float32"
             and c.get("bytes") == MAIN_BYTES}
    a = rep["allreduce_f32"]
    for mode in ("ring", "linear"):
        print(f"phase 13 Allreduce float32 {a['bytes']} B {mode} n={N_RANKS}"
              f" (rank 0 p50 of {len(a['times_ms'][mode])} in turns): "
              f"session comm {a['p50_ms'][mode]:.3f} ms of "
              f"{[round(v, 3) for v in a['times_ms'][mode]]}; COMM_WORLD "
              f"(phase 3) {world.get(mode, float('nan')):.3f} ms "
              f"[{card}]", flush=True)
    print(f"phase 13: grant {rep['grant']}; MPIX_Query_cuda_support "
          f"{rep['query_cuda_support']}; recoveries per rank: comm "
          f"{[d['report']['comm_recoveries'] for d in docs]}, window "
          f"{[d['report']['window_recoveries'] for d in docs]}; Wtick "
          f"{rep['wtick']}; launches (all ranks) {launches}, as derived; "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]", flush=True)
    from ompi_tpu_torch.runtime import launcher

    shm = launcher.shm_dir()
    before = set(os.listdir(shm))
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
           str(N_RANKS), "--timeout", str(ABORT_LIMIT), "--mca",
           "device_plane", "on", "--mca", "coll_cuda", "on",
           os.path.join(root, "ompi_tpu_torch", "examples", "sessions.py"),
           "--abort", f"{ABORT_RANK}:{ABORT_CODE}"]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=ABORT_LIMIT + 30)
    wall = time.perf_counter() - t1
    left = sorted(f for f in set(os.listdir(shm)) - before
                  if f.startswith("ompi_tpu_torch_"))
    if proc.returncode != ABORT_CODE or wall > ABORT_LIMIT or left:
        sys.stderr.write(proc.stderr[-4000:])
        fail(f"phase 13 Abort: exit {proc.returncode} (want {ABORT_CODE}) "
             f"in {wall:.1f} s, files left {left}")
    print(f"phase 13 Abort: rank {ABORT_RANK} of {N_RANKS} called "
          f"mpi.Abort(comm, {ABORT_CODE}) after a device Allreduce; the job "
          f"exited {proc.returncode} in {wall:.1f} s, no file left in "
          f"{shm} [{card}]", flush=True)
    return launches


#: phase 14 (neighbor_halo.py): the wide allgather's bytes a rank, and
#: the bytes its HBM traffic moves over the card: each rank stages its
#: block (read + write) and lands its 4 in-neighbours' (read + write)
HALO_WIDE_BYTES = 64 << 20
HALO_IN_EDGES = 4


def halo_phase(card: str, root: str) -> dict:
    """Phase 14: the topology framework on the card, one 4-rank job of
    ``neighbor_halo.py --device`` under coll/cuda (coll/device serves the
    neighbourhood slots). Every check of every rank must hold (main_path:
    the four contract cases bitwise with nothing staged, the halo's last
    step against its numpy replay and its profile count, the wide block,
    the one exchange against the colour rounds, the Idup and Cart_sub
    Allreduces, the spawned children), each rank's K1-K3 launches per
    part must equal what it derived, and so must each child's. Prints the
    halo step's p50, the wide allgather's p50 beside its bound, the one
    exchange against the rounds in turns and the spawn; returns the
    launches of the parents and the children."""
    t0 = time.perf_counter()
    launches, doc = main_path("neighbor_halo.py", N_RANKS, ["--device"],
                              card, root, "coll_cuda")
    docs = rank_docs(smoke_dir(root, "neighbor_halo.py", N_RANKS), N_RANKS)
    for r, d in enumerate(docs):
        if d["part_launches"] != d["expected_part_launches"] \
                or d["launches"] != d["expected_launches"]:
            fail(f"phase 14 rank {r}: launches per part "
                 f"{d['part_launches']}, derived "
                 f"{d['expected_part_launches']}")
    rep = doc["report"]
    kids = rep["spawn"]["children"]
    if rep["spawn"]["codes"] != [0] * len(kids) or any(
            k["launches"] != k["expected_launches"]
            or not k["device"].startswith("cuda") for k in kids):
        fail(f"phase 14 spawn: codes {rep['spawn']['codes']}, children "
             f"{[(k['device'], k['launches']) for k in kids]}")
    for k in kids:
        for name, v in k["launches"].items():
            launches[name] = launches.get(name, 0) + v
    h, w, rr = rep["halo"], rep["wide"], rep["rounds"]
    print(f"phase 14 contract cases (2 x 2 cart allgather, size-2 "
          f"alltoall, open ring PROC_NULL rows, ragged dist graph) bitwise "
          f"== the host path on every rank, provider coll/device, "
          f"coll_accelerator_staged 0 [{card}]", flush=True)
    print(f"phase 14 halo n={N_RANKS} {h['tile']} x {h['tile']} float32 a "
          f"rank on Create_cart([2, 2], periods, reorder=True), strips of "
          f"depth {h['depth']} ({h['sendbuf_bytes']} B sendbuf): step (pack, "
          f"Neighbor_alltoall, unpack) p50 {h['step_p50_ms']:.4f} ms of "
          f"{h['steps']} (rank 0) {[round(v, 4) for v in h['step_ms']]}; "
          f"profile_Neighbor_alltoall_calls {h['profile_calls']}, "
          f"{h['profile_ms_per_call']:.4f} ms a call; the last step bitwise "
          f"== its numpy replay [{card}]", flush=True)
    moved = N_RANKS * (1 + HALO_IN_EDGES) * 2 * HALO_WIDE_BYTES
    bound = moved / HBM_BYTES_PER_S * 1e3
    print(f"phase 14 Neighbor_allgather n={N_RANKS} {w['bytes']} B float32 "
          f"a rank: p50 {w['p50_ms']:.4f} ms of {len(w['times_ms'])} (rank "
          f"0) {[round(v, 4) for v in w['times_ms']]}; bound {bound:.4f} ms "
          f"({moved} B of HBM traffic), {100 * bound / w['p50_ms']:.1f}% of "
          f"it [{card}]", flush=True)
    for label in ("small", "wide"):
        c = rr[label]
        print(f"phase 14 Neighbor_allgather {c['bytes']} B: one exchange "
              f"p50 {c['one_p50_ms']:.4f} ms vs {rr['colours']} colour "
              f"rounds of permute_dev ({rr['edges']} edges) p50 "
              f"{c['rounds_p50_ms']:.4f} ms, in turns (rank 0: one "
              f"{[round(v, 4) for v in c['one_ms']]}, rounds "
              f"{[round(v, 4) for v in c['rounds_ms']]}), saved "
              f"{c['rounds_p50_ms'] - c['one_p50_ms']:.4f} ms [{card}]",
              flush=True)
    print(f"phase 14 Idup'd cart Allreduce ('ring', 'linear') and Cart_sub "
          f"row Allreduce ('ring') of 64 MiB float32 bitwise; spawn: "
          f"{len(kids)} children on {kids[0]['device']} (world ranks "
          f"{kids[0]['world'][3]}, plane leader {kids[0]['leader']}) each "
          f"ran a bitwise 64 MiB device Allreduce beside the parents' "
          f"arenas, the bridge and merged Allreduces, exit codes "
          f"{rep['spawn']['codes']} ({rep['spawn']['seconds']:.1f} s); "
          f"launches (parents and children) {launches}, as derived; "
          f"{time.perf_counter() - t0:.1f} s wall [{card}]", flush=True)
    return launches


#: phase 15 (ckpt_training.py, parallel_io.py): GPT-2 small's parameters,
#: the pinned device-to-host rate of one card's link (p2p_bandwidth.py's
#: staged copies),
#: and the phase's wall budget
CKPT_PARAMS = 124_439_808
PINNED_GBPS = "25-28"
CKPT_WALL = 60
CKPT_LIMIT = 200  # seconds for the crash job (it dies mid-commit)


def _rank_checks(name: str, docs) -> None:
    for r, d in enumerate(docs):
        bad = [c for c in d["cases"] if not c["ok"]]
        if bad or d["launches"] != d["expected_launches"] \
                or d["coll_accelerator_staged"] != 0 \
                or not d["device"].startswith("cuda"):
            fail(f"phase 15 {name} rank {r}: mismatches {bad}, launches "
                 f"{d['launches']} (derived {d['expected_launches']}), "
                 f"staged {d['coll_accelerator_staged']}, {d['device']}")


def ckpt_phase(card: str, root: str) -> dict:
    """Phase 15: the I/O plane on the card, four 4-rank jobs. F
    (``ckpt_training.py --phase full``): 8 timed ZeRO stage-2 'linear'
    steps at GPT-2 small's width, a snapshot begun after every odd step
    and committed after the next; the newest epoch's restore bitwise on
    every rank; prints the steps with and without a snapshot in flight
    (p50 of 4 each), each rank's copy (device ms, GB/s beside the pinned
    rate), drain and commit times, the restore time. C (``--phase
    crash``): epochs 1 and 2 commit, every rank is killed after its first
    chunk of epoch 3: the job must exit non-zero with no manifest 3 and
    no new ``ompi_tpu_torch_*`` file in the shm dir. R (``--phase
    restore``): epoch 2 of C's directory, trained to step 8: its digest
    must equal F's. Every rank's K2 / K3 launches of F, C and R as
    derived, nothing staged. P (``parallel_io.py --device``): an 8192 x
    8192 float32 array written by one Write_all through a darray view,
    the file against numpy's global array, the ordered records, the
    Read_all bitwise; prints the Write_all rate beside the D2H. The
    checkpoint directories are removed at the end. Returns F's, C's and
    R's launches, C's checkpoint directory (left for phase 16, which
    removes it) and F's final digest."""
    from ompi_tpu_torch.runtime import launcher

    t0 = time.perf_counter()
    launches: dict = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    got, doc = main_path("ckpt_training.py", N_RANKS, ["--phase", "full"],
                         card, root, "coll_cuda", tag="_full")
    add(got)
    full_out = smoke_dir(root, "ckpt_training.py", N_RANKS, tag="_full")
    docs = rank_docs(full_out, N_RANKS)
    _rank_checks("F", docs)
    rep = doc["report"]
    if rep["parameters"] != CKPT_PARAMS:
        fail(f"phase 15 F ran {rep['parameters']} parameters, not GPT-2 "
             f"small's {CKPT_PARAMS}")
    print(f"phase 15 F: ZeRO stage 2 'linear' n={N_RANKS}, "
          f"{rep['parameters']} float32 parameters, {docs[0]['buckets']} "
          f"buckets; step p50 "
          f"(rank 0) with no snapshot in flight {rep['quiet_p50_ms']:.3f} "
          f"ms {[round(v, 3) for v in rep['quiet_ms']]}, with one "
          f"{rep['busy_p50_ms']:.3f} ms "
          f"{[round(v, 3) for v in rep['busy_ms']]} [{card}]", flush=True)
    for r, d in enumerate(docs):
        e = d["report"]["epochs"]
        print(f"phase 15 F rank {r}: ckpt_d2h_ns {d['report']['ckpt_d2h_ns']}"
              f", ckpt_bytes {d['report']['ckpt_bytes']}, ckpt_write_ns "
              f"{d['report']['ckpt_write_ns']} over {len(e)} epochs; per "
              f"epoch: staged {e[0]['staged_bytes']} B, copy (device) ms "
              f"{[round(x['copy_ms'], 3) for x in e]} = GB/s "
              f"{[round(x['copy_gbps'], 2) for x in e]} (pinned D2H "
              f"{PINNED_GBPS} GB/s a link), drain ms "
              f"{[round(x['drain_ms'], 1) for x in e]}, commit ms "
              f"{[round(x['commit_ms'], 1) for x in e]} (write "
              f"{[round(x['write_ms'], 1) for x in e]}); restore "
              f"{d['report']['restore_ms']:.1f} ms, bitwise [{card}]",
              flush=True)
    # C: killed in epoch 3's commit
    crash_out = smoke_dir(root, "ckpt_training.py", N_RANKS, tag="_crash")
    shutil.rmtree(crash_out, ignore_errors=True)
    shm = launcher.shm_dir()
    before = set(os.listdir(shm))
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
           str(N_RANKS), "--timeout", str(CKPT_LIMIT), "--mca",
           "device_plane", "on", "--mca", "coll_cuda", "on",
           os.path.join(root, "ompi_tpu_torch", "examples",
                        "ckpt_training.py"),
           "--phase", "crash", "--out", crash_out]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=CKPT_LIMIT + 30)
    wall = time.perf_counter() - t1
    left = sorted(f for f in set(os.listdir(shm)) - before
                  if f.startswith("ompi_tpu_torch_"))
    ck = os.path.join(crash_out, "ckpt")
    manifests = sorted(f for f in os.listdir(ck) if f.startswith("MANIFEST-"))
    if proc.returncode == 0 or left \
            or manifests != ["MANIFEST-1.json", "MANIFEST-2.json"]:
        sys.stderr.write(proc.stderr[-4000:])
        fail(f"phase 15 C: exit {proc.returncode}, manifests {manifests}, "
             f"files left {left}")
    docs = rank_docs(crash_out, N_RANKS)
    _rank_checks("C", docs)
    for d in docs:
        add(d["launches"])
    print(f"phase 15 C: every rank killed after its first chunk of epoch 3;"
          f" the job exited {proc.returncode} in {wall:.1f} s, manifests "
          f"{manifests}, no file left in {shm}; launches before the kill as"
          f" derived [{card}]", flush=True)
    # R: epoch 2 of C's directory, trained to the last step
    got, rdoc = main_path("ckpt_training.py", N_RANKS,
                          ["--phase", "restore", "--ckpt", ck], card, root,
                          "coll_cuda", tag="_restore")
    add(got)
    _rank_checks("R", rank_docs(smoke_dir(root, "ckpt_training.py", N_RANKS,
                                          tag="_restore"), N_RANKS))
    rr = rdoc["report"]
    if rr["resumed_from"] != 2 or rr["digest"] != rep["digest"]:
        fail(f"phase 15 R: resumed from {rr['resumed_from']}, digest "
             f"{rr['digest']} against F's {rep['digest']}")
    print(f"phase 15 R: epoch {rr['resumed_from']} restored in "
          f"{rr['restore_ms']:.1f} ms (rank 0), steps {rr['first_step']}..8 "
          f"on a rebuilt optimizer; digest {rr['digest']} == F's, bitwise "
          f"[{card}]", flush=True)
    # P: the darray Write_all of an 8192 x 8192 float32 array
    pio = smoke_dir(root, "parallel_io.py", N_RANKS, None)
    shutil.rmtree(pio, ignore_errors=True)
    os.makedirs(pio)
    proc = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
         str(N_RANKS), "--timeout", str(LAUNCH_TIMEOUT), "--mca",
         "device_plane", "on",
         os.path.join(root, "ompi_tpu_torch", "examples", "parallel_io.py"),
         "--device", "--out", pio, "--dir", pio],
        cwd=root, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT + 30)
    for line in proc.stdout.splitlines():
        print(f"{line} [{card}]", flush=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        fail(f"phase 15 P: parallel_io.py --device exited {proc.returncode}")
    pdocs = rank_docs(pio, N_RANKS)
    for r, d in enumerate(pdocs):
        if not all(c["ok"] for c in d["cases"]) \
                or not d["device"].startswith("cuda"):
            fail(f"phase 15 P rank {r}: {d['cases']} on {d['device']}")
    print(f"phase 15 P: Write_all of {pdocs[0]['file_bytes']} B ms per rank "
          f"{[round(d['write_all_ms'], 1) for d in pdocs]} (GB/s "
          f"{[round(d['write_all_gbps'], 3) for d in pdocs]}), the block's "
          f"D2H alone ms {[round(d['d2h_ms'], 2) for d in pdocs]}; the file "
          f"== numpy's global array, records in rank order, Read_all "
          f"bitwise [{card}]", flush=True)
    for d in (os.path.join(full_out, "ckpt"), pio):
        shutil.rmtree(d, ignore_errors=True)
    wall = time.perf_counter() - t0
    print(f"phase 15: launches (F, C, R, all ranks) {launches}, as derived, "
          f"nothing staged; {wall:.1f} s wall (budget {CKPT_WALL} s) "
          f"[{card}]", flush=True)
    return launches, ck, rep["digest"]


#: phase 16: the gated restore's job (A) and the elastic job (B)
INGEST_MCA = ("--mca", "ingest_enable", "1")
KILL_RANK, KILL_STEP = 2, 3
ELASTIC_MCA = ("--mca", "ft", "1", "--mca", "ingest_enable", "1",
               "--mca", "elastic_inject_kill_step", str(KILL_STEP),
               "--mca", "elastic_inject_rank", str(KILL_RANK))
#: GPT-2 small's depth, cut only where a host ZeRO step is too slow for
#: the phase's wall (PERF.md says which)
ELASTIC_LAYERS = 1
ELASTIC_STEPS = 5  # the join's step (the kill is at KILL_STEP)
ELASTIC_LIMIT = 240  # seconds for the elastic job
INGEST_WALL = 90


def ingest_elastic_phase(card: str, root: str, ckpt: str,
                         digest: str) -> dict:
    """Phase 16: the ingest and elastic planes on the card, two 4-rank
    jobs. A (``streaming_ingest.py`` under ``--mca ingest_enable 1``):
    epoch 2 of phase 15's crash run restored through
    ``restore_to_device`` (the whole GPT-2 small tree, 4 streams x depth
    2 of 4 MiB units), the first step gated on its first bucket's leaves
    while the tail uploads (``ingest_early_starts`` >= 1 on every rank),
    the plane up, every leaf on the card, ``ingest_bytes`` the plan's,
    steps 4-8 with their K2 / K3 launches as derived (16 x 37 and 4 x 37
    a step over the ranks) and the final digest F's, bitwise; prints the
    upload's wall, GB/s a rank and the gate's release time. B
    (``elastic_training.py`` under ``--mca ft 1``, rank 2 killed at step
    3): device Allreduces ('linear', K3) on the comms of 4, 3 and 4
    ranks, each bitwise the host linear fold; the broken comm freed; the
    in-memory recovery bitwise the async checkpoint's replay on the
    shrunken comm; a ``spawn_replacement`` joiner at parameter parity
    through the ingest plane; the job exits 0 with rank 2's signal death
    the only failure. Removes ``ckpt`` at the end. Returns the launches of
    both jobs, all ranks."""
    t0 = time.perf_counter()
    launches: dict = {}
    got, doc = main_path("streaming_ingest.py", N_RANKS,
                         ["--ckpt", ckpt, "--expect-digest", digest], card,
                         root, "coll_cuda", extra_mca=INGEST_MCA)
    docs = rank_docs(smoke_dir(root, "streaming_ingest.py", N_RANKS),
                     N_RANKS)
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    rep = doc["report"]
    steps = 8 - rep["first_step"] + 1
    nb = doc["buckets"]
    want = {"ring_rs_hop": 0, "ring_ag_hop": steps * nb * N_RANKS * N_RANKS,
            "linear_fold": steps * nb * N_RANKS}
    if got != want or rep["parameters"] != CKPT_PARAMS:
        fail(f"phase 16 A: launches {got} (derived {want}), parameters "
             f"{rep['parameters']}")
    for r, d in enumerate(docs):
        x = d["report"]
        if x["early_starts"] < 1 or x["digest"] != digest \
                or d["launches"] != d["expected_launches"]:
            fail(f"phase 16 A rank {r}: {x}")
        print(f"phase 16 A rank {r}: epoch {x['resumed_from']} "
              f"({x['upload_units']} units, {x['upload_bytes']} B, "
              f"{x['streams']} streams x depth {x['depth']} x "
              f"{x['chunk_bytes']} B) uploaded in {x['upload_ms']:.1f} ms = "
              f"{x['gbps']:.2f} GB/s; the first leaf's gate released at "
              f"{x['gate_leaf0_ms']:.1f} ms, the first step's (the first "
              f"bucket's leaves) at {x['gate_ms']:.1f} ms with "
              f"{x['tail_units_at_gate']} units still in flight "
              f"(ingest_early_starts {x['early_starts']}); "
              f"restore_to_device {x['restore_to_device_ms']:.1f} ms; steps "
              f"{x['first_step']}-8 ms {[round(v, 1) for v in x['step_ms']]}"
              f" [{card}]", flush=True)
    print(f"phase 16 A: digest {rep['digest']} == phase 15 F's, bitwise; "
          f"K2 {got['ring_ag_hop']} = {steps} steps x {nb} buckets x "
          f"{N_RANKS} x {N_RANKS}, K3 {got['linear_fold']} = {steps} x {nb} "
          f"x {N_RANKS} [{card}]", flush=True)
    shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    # B: the elastic job
    out = smoke_dir(root, "elastic_training.py", N_RANKS)
    shutil.rmtree(out, ignore_errors=True)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
           str(N_RANKS), "--timeout", str(ELASTIC_LIMIT), "--mca",
           "device_plane", "on", "--mca", "coll_cuda", "on", *ELASTIC_MCA,
           os.path.join(root, "ompi_tpu_torch", "examples",
                        "elastic_training.py"),
           "--layers", str(ELASTIC_LAYERS), "--steps", str(ELASTIC_STEPS),
           "--out", out]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=ELASTIC_LIMIT + 30)
    wall = time.perf_counter() - t1
    for line in proc.stdout.splitlines():
        print(f"{line} [{card}]", flush=True)
    joiner = N_RANKS  # the first world rank above the launcher's
    members = [w for w in range(N_RANKS + 1) if w != KILL_RANK]
    names = sorted(f for f in os.listdir(out) if f.endswith(".json")) \
        if os.path.isdir(out) else []
    if proc.returncode != 0 \
            or names != sorted(f"rank{w}.json" for w in members):
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"phase 16 B: elastic_training.py exited {proc.returncode}, "
             f"records {names}")
    el: dict = {}
    for w in members:
        with open(os.path.join(out, f"rank{w}.json")) as f:
            d = json.load(f)
        bad = [c for c in d["cases"] if not c["ok"]]
        k3 = 1 if w == joiner else 3
        if bad or not d["device"].startswith("cuda") \
                or d["launches"].get("linear_fold") != k3 \
                or d["coll_accelerator_staged"] != 0 \
                or not d["report"]["parity_checked"]:
            fail(f"phase 16 B world rank {w}: mismatches {bad}, launches "
                 f"{d['launches']} (K3 derived {k3}), staged "
                 f"{d['coll_accelerator_staged']}, {d['device']}")
        if w != joiner and d["report"]["failures"] \
                != {str(KILL_RANK): "killed by signal 9"}:
            fail(f"phase 16 B world rank {w}: failures "
                 f"{d['report']['failures']}")
        for k, v in d["launches"].items():
            el[k] = el.get(k, 0) + v
        x = d["report"]
        what = (f"joined in {x['join_ms']:.1f} ms" if w == joiner else
                f"{x['parameters']} parameters, recovery "
                f"{x['recovery_ms']:.1f} ms, the broken comm freed in "
                f"{x['free_ms']:.2f} ms")
        print(f"phase 16 B world rank {w}: {what}; host ZeRO step ms "
              f"{[round(v, 1) for v in x['host_step_ms']]} [{card}]",
              flush=True)
    # one K3 a member an Allreduce: the survivors' three, the joiner's one
    # (the killed rank's first launch is in no record)
    if el.get("linear_fold") != 3 * (N_RANKS - 1) + 1:
        fail(f"phase 16 B: K3 launches {el} in the records, not one a "
             "member per Allreduce over the comms of 4, 3 and 4 ranks")
    for k, v in el.items():
        launches[k] = launches.get(k, 0) + v
    print(f"phase 16 B: rank {KILL_RANK} killed at step {KILL_STEP}, the "
          f"only signal death; device Allreduces on the comms of 4, 3 and 4"
          f" ranks bitwise (K3 {el.get('linear_fold')}); recovery bitwise "
          f"the checkpoint replay; the joiner at parity; exit 0 in "
          f"{wall:.1f} s [{card}]", flush=True)
    wall = time.perf_counter() - t0
    print(f"phase 16: launches (A, B, all ranks) {launches}; {wall:.1f} s "
          f"wall (budget {INGEST_WALL} s) [{card}]", flush=True)
    return launches


#: phase 17's jobs (observability.py): A with the three planes on (and
#: the sampler's HTTP endpoint), B with a 2 s hang timeout
OBS_MCA = ("--mca", "trace_enable", "1", "--mca", "telemetry_enable", "1",
           "--mca", "prof_enable", "1", "--mca", "telemetry_port", "-1")
OBS_STALL_MCA = ("--mca", "trace_enable", "1", "--mca", "telemetry_enable",
                 "1", "--mca", "telemetry_hang_timeout", "2", "--mca",
                 "telemetry_watchdog_period", "0.25")
OBS_STALL_RANKS = 2
OBS_WALL = 60  # seconds the phase may take, both jobs and the CLIs


def observability_phase(card: str, root: str) -> dict:
    """Phase 17: the trace, telemetry and prof planes on the card, two
    launcher jobs of ``observability.py`` under coll/cuda. A (4 ranks,
    :data:`OBS_MCA`): the device Allreduce (SUM, float32) at 1 MiB and 64
    MiB under 'linear' and 'ring' and one ``Allreduce_multi`` step of
    ``fused_gradients.py``, in turns with the planes live and switched
    off: bitwise equal on and off and against each mode's fold, the live
    turns' ``launch`` spans equal to the launch pvars' deltas, each rank's
    K1-K3 launches as derived; the ranks' Chrome traces merged by ``python
    -m ompi_tpu_torch.trace merge`` into one timeline of four pids with
    ``api`` and ``coll_cuda``, monotone per tid, and attributed to phases
    by ``python -m ompi_tpu_torch.prof report``. B (2 ranks,
    :data:`OBS_STALL_MCA`): rank 1 sleeps 3.5 s before a device
    Allreduce; rank 0's watchdog dumps the hang naming rank 1 and fires
    ``telemetry_hang``, and the job exits 0. Prints rank 0's p50 on and
    off per case, a guard's ns with the planes off, the sampler's scraped
    page, the xfer lane's GB/s and the phases' wall; fails past
    :data:`OBS_WALL` s. Returns both jobs' launches, all ranks."""
    from ompi_tpu_torch.examples.observability import check_traces

    t0 = time.perf_counter()
    launches: dict = {}
    got, doc = main_path("observability.py", N_RANKS, [], card, root,
                         "coll_cuda", OBS_MCA, tag="_a")
    out = smoke_dir(root, "observability.py", N_RANKS, "coll_cuda", "_a")
    for r, d in enumerate(rank_docs(out, N_RANKS)):
        if d["launches"] != d["expected_launches"]:
            fail(f"phase 17 A rank {r}: K1-K3 launches {d['launches']}, "
                 f"derived {d['expected_launches']}")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    try:
        tr = check_traces(out, N_RANKS)
    except AssertionError as exc:
        fail(f"phase 17 A: the merged trace or the prof report: {exc}")
    rep = doc["report"]
    for name, q in rep["quartiles_ms"].items():
        on, off = q["on"], q["off"]
        n_on = len(rep["times_ms"][name]["on"])
        print(f"phase 17 A {name} n={N_RANKS} (rank 0, {n_on} calls each "
              f"way in turns; p25 / p50 / p75 ms): planes on "
              f"{' / '.join(f'{v:.4f}' for v in on)}, off "
              f"{' / '.join(f'{v:.4f}' for v in off)} (p50 "
              f"{(on[1] / off[1] - 1) * 100:+.1f}%) [{card}]", flush=True)
    print(f"phase 17 A: a disabled site's guard, ns on rank 0's host "
          f"{ {k: round(v, 1) for k, v in rep['guard_ns'].items()} }; "
          f"live turns' launch spans {rep['launch_spans']} = the launch "
          f"pvars' deltas [{card}]", flush=True)
    print(f"phase 17 A: the sampler's page (rank 0, scraped over HTTP): "
          f"{rep['page_lines']} lines, {rep['page_families']} families; "
          f"{rep['page_head']} [{card}]", flush=True)
    for d, c in sorted(tr["transfers"].items()):
        print(f"phase 17 A xfer lane {d}: {c['bytes']} B in {c['spans']} "
              f"spans (4 ranks), avg {c['avg_gbps']} GB/s, peak "
              f"{c['peak_gbps']} GB/s [{card}]", flush=True)
    print(f"phase 17 A: merged {tr['events']} events, pids {tr['pids']}, "
          f"subsystems {tr['cats']}; prof report phases (worst rank, s) "
          f"{tr['phases']} of {tr['wall_s']} s traced [{card}]", flush=True)
    outb = smoke_dir(root, "observability.py", OBS_STALL_RANKS, "coll_cuda",
                     "_b")
    got, docb = main_path("observability.py", OBS_STALL_RANKS,
                          ["--stall", "1"], card, root, "coll_cuda",
                          OBS_STALL_MCA + ("--mca", "telemetry_dump_dir",
                                           outb), tag="_b")
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    b = docb["report"]
    if b["named"] != [[1]] or b["events"] != 1:
        fail(f"phase 17 B: dumps naming {b['named']}, {b['events']} "
             "telemetry_hang events (want one dump naming rank 1)")
    print(f"phase 17 B n={OBS_STALL_RANKS}: rank 1 slept {b['stall_s']} s "
          f"before a device Allreduce; rank 0 waited {b['waited_s']:.2f} s, "
          f"its watchdog dumped {[os.path.basename(p) for p in b['dumps']]}"
          f" naming {b['named'][0]}, telemetry_hang fired; exit 0 "
          f"[{card}]", flush=True)
    wall = time.perf_counter() - t0
    print(f"phase 17: launches (A, B, all ranks) {launches}; {wall:.1f} s "
          f"wall (budget {OBS_WALL} s) [{card}]", flush=True)
    if wall > OBS_WALL:
        fail(f"phase 17 took {wall:.1f} s, past its {OBS_WALL} s budget")
    return launches


#: phase 18 A's fake hosts: 2 ranks each, each its own loopback address
MH_HOSTS = "nodeA:2:127.0.0.2,nodeB:2:127.0.0.3"
MH_WALL = 60  # seconds phase 18 may take, its four parts
MH_TIMEOUT = 150  # seconds per launcher job of phase 18
#: the skew CLI's persistent-straggler bar in phase 18 C: rank 3 is last
#: into the delayed calls' 20 groups of the job's 46 (43%) by construction
MH_PCT = "40"


def _start(cmd, root: str, log: str):
    """Start one command of phase 18, its output to ``log``.out / .err
    (files: a pipe nobody reads yet would stall a chatty command)."""
    out, err = open(log + ".out", "w"), open(log + ".err", "w")
    return subprocess.Popen(cmd, cwd=root, stdout=out, stderr=err,
                            text=True), log, out, err


def _finish(job, what: str, timeout: float = MH_TIMEOUT):
    """Wait for a command :func:`_start` started; fails the smoke on a
    nonzero exit or past ``timeout``. Returns (stdout, stderr)."""
    proc, log, out, err = job
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = 124
    out.close()
    err.close()
    with open(log + ".out") as f:
        stdout = f.read()
    with open(log + ".err") as f:
        stderr = f.read()
    if rc != 0:
        sys.stdout.write(stdout[-4000:])
        sys.stderr.write(stderr[-6000:])
        fail(f"phase 18 {what} exited {rc}")
    return stdout, stderr


def _mh_cases(part: str, docs) -> None:
    for r, d in enumerate(docs):
        bad = [c for c in d["cases"] if not c["ok"]]
        if bad:
            fail(f"phase 18 {part} rank {r}: mismatches {bad}")


def multihost_phase(card: str, root: str) -> dict:
    """Phase 18: the launcher's multi-host, MPMD and binding forms and
    the tune, skew and tools planes on the card (parts A-D, see the
    module docstring); the CLIs run beside the jobs that do not need
    their output. Returns A's and B's K1-K3 launches, all ranks."""
    t0 = time.perf_counter()
    base = os.path.join(root, "build", "ompi_tpu_torch", "smoke_multihost")
    shutil.rmtree(base, ignore_errors=True)
    dumps, out_a = os.path.join(base, "dumps"), os.path.join(base, "a")
    os.makedirs(dumps)
    launcher = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher",
                "--timeout", str(MH_TIMEOUT - 30)]
    ex = os.path.join(root, "ompi_tpu_torch", "examples")
    launches: dict = {}

    def run(cmd, what):
        return _finish(_start(cmd, root, os.path.join(base, what)), what)

    # -- A: two fake hosts, full width
    stdout, _ = run(launcher + [
        "--host", MH_HOSTS, "--launch-agent", "local", "--bind-to", "core",
        "--mca", "device_plane", "on", "--mca", "coll_cuda", "on",
        "--mca", "coll_device_hier", "2", "--mca", "tune_observe", "1",
        "--mca", "tune_dump", os.path.join(dumps, "tune_r{rank}.json"),
        "--mca", "tune_db_dir", dumps, "--mca", "skew_level", "2",
        "--mca", "skew_dump", os.path.join(dumps, "skew_r{rank}.json"),
        os.path.join(ex, "multihost.py"), "--device", "--out", out_a], "A")
    for line in stdout.splitlines():
        print(f"phase 18 A: {line} [{card}]", flush=True)
    docs = rank_docs(out_a, N_RANKS)
    _mh_cases("A", docs)
    for r, d in enumerate(docs):
        want_host = "nodeA" if r < 2 else "nodeB"
        if d["host"] != want_host or d["local_size"] != 2:
            fail(f"phase 18 A rank {r}: host {d['host']}, local size "
                 f"{d['local_size']}")
        if not d["bind_cpus"] or set(d["affinity"]) != {
                int(c) for c in d["bind_cpus"].split(",")}:
            fail(f"phase 18 A rank {r}: affinity {d['affinity']}, bound "
                 f"set {d['bind_cpus']!r}")
        if not d["device"].startswith("cuda") \
                or d["coll_accelerator_staged"] != 0:
            fail(f"phase 18 A rank {r}: on {d['device']}, "
                 f"{d['coll_accelerator_staged']} calls staged")
        if d["launches"] != d["expected_launches"]:
            fail(f"phase 18 A rank {r}: K1-K3 launches {d['launches']}, "
                 f"derived {d['expected_launches']}")
        for k, v in d["launches"].items():
            launches[k] = launches.get(k, 0) + v
    d0 = docs[0]
    t_a = time.perf_counter() - t0
    print(f"phase 18 A n={N_RANKS} on 2 fake hosts, {d0['bytes']} B float32 "
          f"SUM, rank 0's p50 ms over the undelayed / delayed calls: "
          + ", ".join(f"{m} {d0['p50_ms'][m]:.3f} / "
                      f"{d0['late_p50_ms'][m]:.3f}" for m in d0["p50_ms"])
          + f"; affinities {[d['affinity'] for d in docs]}; K1-K3 "
          f"{launches} as derived; {t_a:.1f} s [{card}]", flush=True)

    # -- B: the tune tooling and the table it writes
    tables = os.path.join(base, "h100")
    merged = os.path.join(base, "tune_merged.json")
    stdout, _ = run([sys.executable, "-m", "ompi_tpu_torch.tune", "report",
                     "--tables", tables, "--json", merged]
                    + [os.path.join(dumps, f"tune_r{r}.json")
                       for r in range(N_RANKS)], "B_report")
    for line in stdout.splitlines():
        print(f"phase 18 B: {line} [{card}]", flush=True)
    if "[cuda-vs-device]" not in stdout:
        fail("phase 18 B: the report names no cuda-vs-device crossover")
    with open(tables + "_cuda.json") as f:
        table = json.load(f)
    print(f"phase 18 B: the H100 candidate table {tables}_cuda.json: "
          f"{json.dumps(table)} [{card}]", flush=True)
    out_b, dumps_b = os.path.join(base, "b"), os.path.join(base, "dumps_b")
    os.makedirs(dumps_b)
    job_b = _start(launcher + [
        "-n", str(N_RANKS), "--mca", "device_plane", "on",
        "--mca", "coll_cuda", "on", "--mca", "coll_cuda_switchpoints",
        tables + "_cuda.json", "--mca", "tune_observe", "1",
        "--mca", "tune_dump", os.path.join(dumps_b, "tune_r{rank}.json"),
        os.path.join(ex, "tune_observe.py"), "--table",
        tables + "_cuda.json", "--bytes", "256m", "--out", out_b], root,
        os.path.join(base, "B_job"))
    # D's MPMD job, C's CLI and D's tools.info beside B's job
    appfile = os.path.join(base, "appfile")
    prog = os.path.join(ex, "mpmd.py")
    flags = "--no-spawn --device --apps 1,3 --msgq"
    with open(appfile, "w") as f:
        f.write(f"-n 1 {prog} driver {flags}\n-n 3 {prog} worker {flags}\n")
    job_d = _start(launcher + ["--mca", "device_plane", "on", "--mca",
                               "mpir_dump_on_signal", "on", "--app",
                               appfile], root, os.path.join(base, "D"))
    ana = os.path.join(base, "skew_analysis.json")
    job_c = _start([sys.executable, "-m", "ompi_tpu_torch.skew", "report",
                    "--pct", MH_PCT, "--json", ana]
                   + [os.path.join(dumps, f"skew_r{r}.json")
                      for r in range(N_RANKS)], root,
                   os.path.join(base, "C"))
    job_info = _start([sys.executable, "-m", "ompi_tpu_torch.tools.info",
                       "--json", "--level", "9"], root,
                      os.path.join(base, "D_info"))
    stdout, _ = _finish(job_b, "B read-back")
    for line in stdout.splitlines():
        print(f"phase 18 B: {line} [{card}]", flush=True)
    docs_b = rank_docs(out_b, N_RANKS)
    _mh_cases("B", docs_b)
    for d in docs_b:
        for k, v in d["launches"].items():
            launches[k] = launches.get(k, 0) + v
    print(f"phase 18 B: the table names {docs_b[0]['named']!r}, which ran "
          f"every call ({docs_b[0]['ran']}), tune_table_errors 0, bitwise; "
          f"rank 0's p50 {docs_b[0]['p50_ms']:.3f} ms (D's job and the "
          f"CLIs beside it) [{card}]", flush=True)

    # -- C: the skew CLI over A's dumps
    stdout, _ = _finish(job_c, "C")
    with open(ana) as f:
        a = json.load(f)
    named = {v["rank"]: v for v in a["stragglers"]}
    wait = {int(r): w for r, w in a["exposed_wait_ns"].items()}
    if named.get(3, {}).get("cause") != "compute" \
            or min(wait, key=wait.get) != 3:
        sys.stdout.write(stdout[-4000:])
        fail(f"phase 18 C: the straggler verdicts {a['stragglers']}, exposed "
             f"wait {wait} (want rank 3 named, its lateness compute, and "
             "the least wait)")
    verdict = [line for line in stdout.splitlines()
               if line.startswith("PERSISTENT STRAGGLER: rank 3 ")]
    print(f"phase 18 C: {verdict[0]} (bar {MH_PCT}%); merge's error bar "
          f"±{a['clock_err_ns'] / 1e3:.1f} us; exposed wait by rank (ms) "
          f"{ {r: round(w / 1e6, 1) for r, w in a['exposed_wait_ns'].items()} }"
          f" [{card}]", flush=True)

    # -- B's regression verdicts; D: MPMD on the card, the msgq dump and
    # tools.info's listing
    job_reg = _start([sys.executable, "-m", "ompi_tpu_torch.tune", "report",
                      "--db", merged]
                     + [os.path.join(dumps_b, f"tune_r{r}.json")
                        for r in range(N_RANKS)], root,
                     os.path.join(base, "B_regressions"))
    stdout, _ = _finish(job_reg, "B regressions")
    verdicts = stdout[stdout.index("-- regression verdicts"):]
    for line in verdicts.strip().splitlines():
        print(f"phase 18 B (B's dumps --db A's merged document): {line} "
              f"[{card}]", flush=True)
    stdout, stderr = _finish(job_d, "D")
    if "posted receives (1):" not in stderr \
            or "src 0 tag 77" not in stderr:
        sys.stderr.write(stderr[-4000:])
        fail("phase 18 D: rank 1's SIGUSR1 dump shows no posted receive")
    apps = sorted(line for line in stdout.splitlines() if "appnum=" in line)
    print(f"phase 18 D: {apps}; rank 1's dump: "
          + "; ".join(line.strip() for line in stderr.splitlines()
                      if "posted" in line or "tag 77" in line)
          + f" [{card}]", flush=True)
    stdout, _ = _finish(job_info, "D info")
    info = json.loads(stdout)
    if not {"cuda", "device"} <= set(info["frameworks"]["coll"]) \
            or "osc_cuda" not in info["cvars"]:
        fail(f"phase 18 D: tools.info lists {info['frameworks']}")
    print(f"phase 18 D: tools.info frameworks {info['frameworks']}, "
          f"{len(info['cvars'])} cvars (osc_cuda among them), "
          f"{len(info['events'])} event types [{card}]", flush=True)
    wall = time.perf_counter() - t0
    print(f"phase 18: launches (A, B, all ranks) {launches}; {wall:.1f} s "
          f"wall (A {t_a:.1f} s; budget {MH_WALL} s) [{card}]", flush=True)
    if wall > MH_WALL:
        fail(f"phase 18 took {wall:.1f} s, past its {MH_WALL} s budget")
    return launches


#: the ring example's lines on 4 ranks (examples/ring_c.c's countdown)
RING_TEXT = (["Process 0 sending 10 to 1, tag 201 (4 processes in ring)",
              "Process 0 sent to 1"]
             + [f"Process 0 decremented value: {v}" for v in range(9, -1, -1)]
             + [f"Process {r} exiting" for r in range(4)])
P2P_TIMEOUT = 300  # seconds per host-plane launcher job


def launch_text(root: str, nranks: int, prog: str, args=(), mca=()):
    """One launcher job's stdout lines (no device plane). The ranks
    run block-buffered, so each writes its lines at exit in one piece:
    unbuffered ranks sharing the pipe can split a line."""
    cmd = [sys.executable, "-m", "ompi_tpu_torch.runtime.launcher", "-n",
           str(nranks), "--timeout", str(P2P_TIMEOUT), *mca,
           os.path.join(root, "ompi_tpu_torch", "examples", prog), *args]
    env = dict(os.environ)
    env.pop("PYTHONUNBUFFERED", None)
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=P2P_TIMEOUT + 30)
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        fail(f"{prog} on {nranks} ranks exited {proc.returncode}")
    return proc.stdout.splitlines()


def host_plane_phase(torch, card: str, root: str) -> None:
    """Phase 4: the host plane and device-tensor point-to-point."""
    import socket

    from ompi_tpu_torch import errors, mpi
    from ompi_tpu_torch.core import cvar, native
    from ompi_tpu_torch.runtime import device_plane

    # the sm btl's C ring builds here, before the ranks look for it; a
    # failed build would leave them on the Python ring
    if native.lib() is None:
        fail(f"the sm ring's C code ({native.SRC}) did not build or load")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        ring, hello = ex.map(lambda prog: launch_text(root, 4, prog),
                             ("ring.py", "hello.py"))
    zero = [ln for ln in ring if ln.startswith("Process 0")]
    if sorted(ring) != sorted(RING_TEXT) or zero != [
            ln for ln in RING_TEXT if ln.startswith("Process 0")]:
        fail(f"ring.py printed {ring}, not {RING_TEXT}")
    host = socket.gethostname()
    want = [f"Hello, world, I am {r} of 4 ({host})" for r in range(4)]
    if sorted(hello) != want:
        fail(f"hello.py printed {hello}, not {want}")
    print(f"host plane: ring.py and hello.py on 4 ranks print the expected "
          f"{len(ring)} + {len(hello)} lines ({time.perf_counter() - t0:.1f}"
          f" s wall) [{card}]", flush=True)

    out = os.path.join(root, "build", "ompi_tpu_torch", "smoke_p2p")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    launch_text(root, 2, "p2p_bandwidth.py", ["--out", out])
    with open(os.path.join(out, "p2p.json")) as f:
        doc = json.load(f)
    if not doc["ok"] or not doc["device"].startswith("cuda"):
        fail(f"p2p_bandwidth: {doc}")
    if doc["sm_ring"] != ["c", "c"]:
        fail(f"p2p_bandwidth ran the sm rings {doc['sm_ring']}, not the C "
             "ring on both ranks")
    print(f"p2p: the sm btl ran the C ring ({native.SRC.split(os.sep)[-1]})"
          f" on ranks {doc['sm_ring']} [{card}]", flush=True)
    for c in doc["pingpong"]:
        print(f"p2p n=2 float32 {c['bytes']} B, chunk {c['chunk_bytes']} B: "
              f"round trip p50 {c['rt_p50_ms']:.4f} ms over {c['iters']}, "
              f"one way {c['oneway_ms']:.4f} ms = {c['oneway_gbps']:.3f} "
              f"GB/s, echoes bitwise {c['ok']} [{card}]", flush=True)
    for c in doc["stages"]:
        print(f"p2p stages {c['bytes']} B (p50): pinned D2H copy_ "
              f"{c['d2h_ms']:.4f} ms = {c['d2h_gbps']:.3f} GB/s, pinned H2D "
              f"copy_ {c['h2d_ms']:.4f} ms = {c['h2d_gbps']:.3f} GB/s, host "
              f"numpy one way through the pml {c['host_oneway_ms']:.4f} ms = "
              f"{c['host_oneway_gbps']:.3f} GB/s [{card}]", flush=True)
    print("p2p dtypes n=2: " + ", ".join(
        f"{c['name']} {c['bytes']} B bitwise {c['ok']}" for c in doc["dtypes"])
        + f" ({time.perf_counter() - t0:.1f} s wall) [{card}]", flush=True)
    ring = json.loads(launch_text(root, 4, "p2p_bandwidth.py",
                                  ["--ring-bytes", "64m", "--iters", "3"])[-1])
    r = ring["ring"]
    if not ring["ok"] or ring["sm_ring"] != ["c"] * 4:
        fail(f"the 4-rank Sendrecv ring: {ring}")
    print(f"p2p Sendrecv ring n=4 of {r['bytes']} B float32 CUDA tensors: "
          f"p50 {r['p50_ms']:.4f} ms, bitwise on every rank [{card}]",
          flush=True)

    # a one-rank job in this process on the CPU platform: every entry
    # point refuses a CUDA tensor
    assert device_plane.platform() == "cuda"
    cvar.set("device_plane_platform", "cpu")
    comm = mpi.Init()
    t = torch.ones(4, device="cuda")
    try:
        for name, call in (("Send", lambda: comm.Send(t, dest=0)),
                           ("Isend", lambda: comm.Isend(t, dest=0)),
                           ("Recv", lambda: comm.Recv(t, source=0)),
                           ("Irecv", lambda: comm.Irecv(t, source=0))):
            try:
                call()
                fail(f"comm.{name} of a CUDA tensor on a CPU-platform rank "
                     "was not refused")
            except errors.MPIError as e:
                if e.error_class != errors.ERR_ARG:
                    raise
    finally:
        mpi.Finalize()
        cvar.set("device_plane_platform", "cuda")
    print(f"p2p: comm.Send / Isend / Recv / Irecv of a CUDA tensor on a "
          f"CPU-platform rank raise ERR_ARG [{card}]", flush=True)


#: the datatype phase's field side (a face of a 512^3 float32 field) and
#: its block layout (every other 4096-float block of a 256 MiB tensor)
FIELD, DT_BLOCK = 512, 4096


def datatype_layouts(D):
    """(name, tensor shape, datatype, strided view of the same layout)
    of the datatype phase's three layouts."""
    rows = (64 << 20) // (2 * DT_BLOCK)  # 256 MiB of float32, 2 blocks a row
    return (
        ("halo column", (HALO, HALO), D.vector(HALO, 1, HALO, D.FLOAT),
         lambda x: x[:, 0]),
        ("512^3 field face", (FIELD,) * 3,
         D.subarray([FIELD] * 3, [FIELD, FIELD, 1], [0, 0, 0], D.FLOAT),
         lambda x: x[:, :, 0]),
        ("alternate 4096-float blocks", (rows, 2 * DT_BLOCK),
         D.vector(rows, DT_BLOCK, 2 * DT_BLOCK, D.FLOAT),
         lambda x: x[:, :DT_BLOCK]),
    )


def datatype_phase(torch, card: str, root: str) -> dict:
    """Phase 5: the datatype engine (no kernel of its own: the device
    convertor gathers with index_select and scatters with index_copy_).
    In this process, for each layout: ``datatype.device.pack`` and
    ``unpack`` bitwise against the host convertor's bytes (the scatter
    into a poisoned template, whose gaps must keep the poison), the
    pack's first call (the index vector built and sent to the card) and
    cached p50, the unpack's p50, a strided-view ``copy_`` of the same
    layout each way, and the bound. Then a 4-rank launcher job of
    ``examples/datatype_exchange.py`` under coll/cuda (tuple-form halo
    Send / Recv of CUDA tensors, Allreduce and Bcast of a column, K1-K3
    counted) and a 2-rank host job with rank 1 big-endian. Returns the
    4-rank job's K1-K3 launches."""
    import numpy as np

    from ompi_tpu_torch.datatype import convertor as cv
    from ompi_tpu_torch.datatype import datatype as D
    from ompi_tpu_torch.datatype import device as dd

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for i, (name, shape, dt, view) in enumerate(datatype_layouts(D)):
        g = torch.Generator(device=dev).manual_seed(41 + i)
        x = torch.randn(shape, generator=g, device=dev)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        packed = dd.pack(x, dt, 1)
        torch.cuda.synchronize(dev)
        first_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()  # its numpy share: the index vector again
        dd.element_indices(dt, 1, 4)
        build_ms = (time.perf_counter() - t1) * 1e3
        host = x.cpu().numpy()
        wire = cv.pack(host, dt, 1)
        if packed.cpu().numpy().tobytes() != wire:
            fail(f"datatype {name}: the device pack differs from the host "
                 "convertor's bytes")
        tpl = torch.empty(shape, device=dev)
        tpl.view(torch.uint8).fill_(POISON)  # the gaps must keep it
        want = tpl.cpu().numpy()
        cv.unpack(wire, want, dt, 1)
        if dd.unpack(packed, dt, 1, tpl) is not tpl \
                or tpl.cpu().numpy().tobytes() != want.tobytes():
            fail(f"datatype {name}: the device unpack differs from the host "
                 "convertor's (or moved a gap)")
        del host, want
        pack_ms = median_ms(lambda: dd.pack(x, dt, 1), torch)
        unpack_ms = median_ms(lambda: dd.unpack(packed, dt, 1, tpl), torch)
        v = view(x)
        out = torch.empty(v.shape, device=dev)
        vpack_ms = median_ms(lambda: out.copy_(v), torch)
        if not torch.equal(out.reshape(-1).view(torch.int32),
                           packed.view(torch.int32)):
            fail(f"datatype {name}: the strided view is not the type's "
                 "layout")
        vt = view(tpl)
        vunpack_ms = median_ms(lambda: vt.copy_(out), torch)
        spans = dt.spans
        touched = int(np.maximum(spans[:, 1], SECTOR).sum())
        bound_ms = (touched + dt.size) / HBM_BYTES_PER_S * 1e3
        idx_bytes = 8 * packed.numel()
        print(f"datatype {name} ({dt.name}, {len(spans)} spans, "
              f"{packed.numel()} float32 = {dt.size} B packed): device pack "
              f"first call {first_ms:.4f} ms (index vector of {idx_bytes} B "
              f"built and copied to the card; building it alone "
              f"{build_ms:.4f} ms), cached p50 {pack_ms:.4f} ms; "
              f"unpack p50 {unpack_ms:.4f} ms; strided-view copy_ pack "
              f"{vpack_ms:.4f} ms, unpack {vunpack_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({touched} B of the layout, a {SECTOR}-B "
              f"sector per strided element, + {dt.size} B packed, at 3.35 "
              f"TB/s); pack and unpack bitwise equal to the host convertor, "
              f"gaps unchanged [{card}]", flush=True)
        del x, tpl, packed, out, v, vt
        torch.cuda.empty_cache()
    print(f"datatype phase in process: {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)

    launches, _ = main_path("datatype_exchange.py", N_RANKS, [], card, root)
    out = os.path.join(root, "build", "ompi_tpu_torch", "smoke_hetero")
    shutil.rmtree(out, ignore_errors=True)
    t0 = time.perf_counter()
    launch_text(root, 2, "datatype_exchange.py", ["--hetero", "--out", out])
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            doc = json.load(f)
        if doc["arch"] != ("big" if r == 1 else "little") or not all(
                c["ok"] for c in doc["cases"]) or len(doc["cases"]) != 3:
            fail(f"the heterogeneous host job, rank {r}: {doc}")
    print(f"datatype heterogeneous host job n=2, rank 1 big-endian: struct "
          f"Send / Recv both ways and float64 / int32 Allreduce equal to "
          f"the values sent ({time.perf_counter() - t0:.1f} s wall) "
          f"[{card}]", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        from ompi_tpu_torch.coll import cuda_kernels as K
        from ompi_tpu_torch.osc import cuda_kernels as O
    except ImportError as exc:
        fail(f"the ompi_tpu_torch package is not beside this script: {exc}")
    card = card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} [{card}]", flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:  # one nvcc per source, side by side
        for job in [pool.submit(K.build, verbose=True),
                    pool.submit(K.build, K.GEMM_SRC, verbose=True),
                    pool.submit(O.build, verbose=True)]:
            job.result()
    K.lib()
    K.gemm_lib()
    O.lib()
    print(f"build: {SRC}, {GEMM_SRC} and {RMA_SRC} built for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)

    # the plain and library float32 products run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    engine = engine_checks(torch, K, O, dev, card)
    rows = kernel_checks(torch, K, dev, card, engine)
    rows += rma_checks(torch, O, dev, card, engine)
    # K1-K3's launches: summed over every collectives job
    coll: dict = {}

    def collectives(nranks, args, component="coll_cuda"):
        got, doc = main_path("device_collectives.py", nranks, args, card,
                             root, component)
        for k, v in got.items():
            coll[k] = coll.get(k, 0) + v
        if component is None and doc["provider"] != "device":
            fail(f"the device-plane-only job was served by "
                 f"{doc['provider']}")
        return doc

    world_doc = collectives(N_RANKS, ["--sizes", "1k,1m,64m,256m",
                                      "--kinds", "allreduce,rsag,ops",
                                      "--ops-bytes", str(OPS_BYTES)])
    collectives(3, ["--sizes", "1k,1m,64m", "--kinds", "allreduce,rsag"])
    # coll/device alone (no coll_cuda): BASELINE's Bcast (config 2, 1 MiB
    # float32 on 8 ranks) and Alltoall (config 5, int32), the three
    # reductions in every mode, the ops outside the kernels and every slot
    # on COMM_SELF, and beside them the host collectives (BASELINE config
    # 3's host baseline and the staged calls on 4 ranks, config 2's on 8);
    # then the rest of its slot table, a job per family
    doc4 = collectives(N_RANKS, [
        "--kinds", "allreduce,rsag,bcast,alltoall,ops,self,host,staged",
        "--sizes", "1m,64m", "--rsag-bytes", "1m,64m",
        "--alltoall-bytes", "1m,64m", "--ops-bytes", str(OPS_BYTES),
        "--host-sizes", HOST_SIZES, "--host-forced-bytes", "1m",
        "--host-bcast-bytes", "1m", "--staged-bytes", "64m",
        "--staged-op-bytes", "1m"], None)
    doc8 = collectives(BCAST_RANKS, [
        "--kinds", "bcast,host", "--host-sizes", "",
        "--host-forced-bytes", "", "--host-bcast-bytes", "1m"], None)
    host_collectives_report(doc4, doc8, card)
    for kinds, args in REST_JOBS:
        collectives(N_RANKS, ["--kinds", kinds, *args], None)
    train, doc = main_path("zero_training.py", N_RANKS, [], card, root)
    if doc["parameters"] != 124_439_808:
        fail(f"zero_training ran {doc['parameters']} parameters, not "
             "GPT-2 small's 124,439,808")
    print(f"training step n={N_RANKS} (rank 0 p50 ms): "
          + ", ".join(f"{m} {v['p50']:.3f}" for m, v in
                      doc["step_ms"].items())
          + f"; allgather_matmul p50 ms {doc['allgather_matmul_ms']} "
          f"[{card}]", flush=True)
    z3 = doc["zero3"]
    if z3["layers"] != 15 or z3["misses"] \
            or z3["resident_hwm_bytes"] > z3["resident_limit_bytes"]:
        fail(f"stage 3's forward pass: {z3}")
    print(f"stage 3 n={N_RANKS} (rank 0): forward pass p50 "
          f"{z3['forward_p50_ms']:.3f} ms over {z3['layers']} layers, "
          f"{z3['hits']} prefetch hits, {z3['misses']} misses; residency "
          f"high watermark {z3['resident_hwm_bytes']} B <= "
          f"{z3['resident_limit_bytes']} B (shards {z3['shard_bytes']} B "
          f"+ 2 x {z3['max_layer_bytes']} B), {z3['arenas']} arenas "
          f"mapped by the rank; c_fc.w matmul pass (12 K6 "
          f"products) p50 {z3['matmul_pass_p50_ms']:.3f} ms; launches per "
          f"phase (rank 0) {doc['phase_launches']} [{card}]", flush=True)
    split = {k: train.get(k, 0) for k in K6_PATH_SPLIT}
    if split != K6_PATH_SPLIT:
        fail(f"the training path's K6 launches split {split}, not as "
             f"scheduled {K6_PATH_SPLIT}")
    main_path("zero_training.py", 3, ["--layers", "4"], card, root)
    halo, doc = main_path("halo_exchange.py", N_RANKS, [], card, root,
                          "osc_cuda")
    osc_report("halo_exchange", N_RANKS, doc, card)
    _, doc = main_path("halo_exchange.py", 3, ["--size", str(HALO // 2)],
                       card, root, "osc_cuda")
    osc_report("halo_exchange", 3, doc, card)
    emb, emb_doc = main_path("embedding_table.py", N_RANKS, [], card, root,
                             "osc_cuda")
    osc_report("embedding_table", N_RANKS, emb_doc, card)
    _, doc = main_path("embedding_table.py", 3,
                       ["--rows", str(EMB_ROWS // 4), "--batch", "128"],
                       card, root, "osc_cuda")
    osc_report("embedding_table", 3, doc, card)
    osc = {k: halo.get(k, 0) + emb.get(k, 0) for k in {*halo, *emb}}
    for k in ("rma_apply", "rma_apply_strided_batch", "rma_read_batch",
              "rma_permute_recv_batch"):
        if osc.get(k, 0) <= 0:
            fail(f"{k} never launched on the one-sided paths: {osc}")
    # one grouped K10 launch per reader and lookup exchange (every reader
    # reads rows of every owner, at most COPY_CAP of them)
    want = N_RANKS * emb_doc["exchanges"]["lookup"]
    if emb["rma_permute_recv_batch"] != want:
        fail(f"the 4-rank lookup launched K10 {emb['rma_permute_recv_batch']}"
             f" times, not once per reader and exchange ({want})")
    print(f"K10 on the 4-rank embedding lookup: {want} launches, one per "
          f"reader and exchange ({N_RANKS} readers x "
          f"{emb_doc['exchanges']['lookup']} exchange), each landing every "
          f"owner's block [{card}]", flush=True)
    am = am_phase(card, root)
    de = device_epoch_phase(card, root)
    # phases 7 and 8's K1-K3 launches join the collectives jobs'
    for k, v in context_parallel_phase(card, root).items():
        coll[k] = coll.get(k, 0) + v
    for k, v in model_phase(card, root).items():
        coll[k] = coll.get(k, 0) + v
    # the datatype job's K1-K3 launches join the collectives jobs'
    for k, v in datatype_phase(torch, card, root).items():
        coll[k] = coll.get(k, 0) + v
    # and so do phase 10's and 11's
    for k, v in hier_phase(card, root).items():
        coll[k] = coll.get(k, 0) + v
    for k, v in serve_phase(card, root).items():
        coll[k] = coll.get(k, 0) + v
    tools = tools_phase(card, root)
    # phase 13's K1-K3 join the collectives jobs'; its K7-K10 count apart
    sessions = sessions_phase(card, root, world_doc)
    for k in ("ring_rs_hop", "ring_ag_hop", "linear_fold"):
        coll[k] = coll.get(k, 0) + sessions.pop(k, 0)
    # and so do phase 14's, the spawned children's among them
    for k, v in halo_phase(card, root).items():
        coll[k] = coll.get(k, 0) + v
    # and so do phase 15's (the checkpointed training jobs) and phase 16's
    # (the gated restore's steps and the elastic job's Allreduces)
    ckpt_launches, ckpt, digest = ckpt_phase(card, root)
    for k, v in ckpt_launches.items():
        coll[k] = coll.get(k, 0) + v
    for k, v in ingest_elastic_phase(card, root, ckpt, digest).items():
        coll[k] = coll.get(k, 0) + v
    # and so do phase 17's (the observability jobs)
    for k, v in observability_phase(card, root).items():
        coll[k] = coll.get(k, 0) + v
    # and phase 18's (the two fake hosts' job and the table's read-back)
    for k, v in multihost_phase(card, root).items():
        coll[k] = coll.get(k, 0) + v
    for r in rows:
        if "note" not in r:  # a kernel no path runs keeps 0
            r["launches"] = sum(p.get(r["name"], 0) for p in
                                (coll, train, osc, am, de, tools, sessions))
    print(f"K1-K3 launches over the collectives jobs (all ranks): "
          f"{ {k: coll[k] for k in sorted(coll)} } [{card}]", flush=True)
    host_plane_phase(torch, card, root)

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
