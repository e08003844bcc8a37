"""trace/ — span-structured distributed tracing over the MPI_T planes.

The port's copy of ``ompi_tpu.trace``: a per-process bounded ring-buffer
span recorder (:mod:`~ompi_tpu_torch.trace.recorder`) instrumented at
the layers a training step touches — MPI API entry and exit (through the
PMPI interposition, ``profile.py``), coll/device plan builds and launches,
coll/cuda launches, part/ Pready -> bucket-flush causality, pml/btl send
and receive, and the accelerator's copies (the prof plane's ``xfer``
lane). Export is Chrome trace-event JSON loadable in Perfetto
(:mod:`~ompi_tpu_torch.trace.export`), per-rank files merge into one
timeline with ``python -m ompi_tpu_torch.trace merge``
(:mod:`~ompi_tpu_torch.trace.merge`), and log2-binned latency histograms
ride the pvar plane so ``mpit`` sessions can read them.

Cost: one attribute load and one branch per instrumented site while
disabled (``recorder.RECORDER is None``: no span is ever constructed);
enable with the cvar ``trace_enable``, the env ``OMPI_TPU_TRACE``, or
:func:`recorder.enable`.
"""

from ompi_tpu_torch.trace import export, merge, recorder  # noqa: F401
