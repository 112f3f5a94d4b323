"""Hardware constants: the reference's TPU v5e table, and the NVIDIA H100
beside it.

The TPU v5e constants keep their names and the reference's values, because
the copied cluster and bridge modules read them and their numbers must stay
the reference's: ``cluster/power.py::tpu_v5e_power_model`` builds the
``tpuv5e`` SKU's power curve from them, and ``bridge/calibrate.py::
analytic_job`` turns a profile's duty cycle into FLOPs with
``PEAK_FLOPS_BF16`` (the profiler divides by the same constant, so the two
cancel). Nothing measured on the H100 is derived from them.

The ``H100_*`` table is what runs on the card: the SXM part's data-sheet
rates (dense, without sparsity) at its full power limit. ``chip_smoke.py``
hands ``H100_PEAK_FLOPS_BF16`` to ``EarlyStageProfiler`` as ``peak_flops``,
so the duty cycle it reports on the card is a share of the H100's peak.
``H100_NVLINK_BW`` is NVLink's rate each way between the eight cards of one
host; ``launch/dryrun.py`` divides a step's collective bytes by it. A
16-rank model axis spans two 8-card hosts, whose link is slower, so that
term is a lower bound.
"""

PEAK_FLOPS_BF16 = 197e12  # FLOP/s per chip
HBM_BW = 819e9  # bytes/s per chip
ICI_BW = 50e9  # bytes/s per link
HBM_BYTES = 16 * 2**30  # v5e HBM capacity per chip

# power model (used by the TPU flavour of the cluster simulator)
CHIP_IDLE_W = 60.0
CHIP_PEAK_W = 220.0
HOST_IDLE_W = 250.0  # per-host (CPU tray) idle
HOST_PEAK_W = 450.0
CHIPS_PER_HOST = 8

# host input-pipeline capacity per tray (Synergy-style disaggregated
# resources): sustained throughput of each pipeline stage at 100% of the
# stage, in *text-equivalent tokens/s* — per-family weights in
# ``roofline.analysis.analytic_host_profile`` rescale modality-heavy
# inputs (image patches, audio frames) into this unit
HOST_CPU_TOKENS_PER_S = 5.0e4  # tokenize / augment / batch / collate
HOST_DRAM_TOKENS_PER_S = 1.2e5  # staging copies (fetch->pin->DMA chain)
HOST_LOADER_TOKENS_PER_S = 8.0e4  # storage fetch + shard decode

# NVIDIA H100 SXM (NVIDIA's data sheet, dense rates): the card the port runs on
H100_PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 / fp16 on the tensor cores
H100_PEAK_FLOPS_TF32 = 495e12  # FLOP/s, TF32 on the tensor cores
H100_PEAK_FLOPS_FP32 = 67e12  # FLOP/s, fp32 outside the tensor cores
H100_HBM_BW = 3.35e12  # bytes/s
H100_HBM_BYTES = 80e9  # HBM capacity, bytes
H100_NVLINK_BW = 450e9  # bytes/s each way, NVLink between the cards of one host
H100_POWER_LIMIT_W = 700.0  # the SXM part's board limit; nvidia-smi's power.limit may read lower
