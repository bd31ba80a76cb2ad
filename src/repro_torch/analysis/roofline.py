"""Three-term roofline of a traced dry-run cell at the H100's rates
(``repro/analysis/roofline.py``, whose constants are TPU v5e's).

  compute_s    = traced dot FLOPs a rank / 989 TFLOP/s (bf16 dense)
  memory_s     = analytic HBM bytes a rank (below) / 3.35 TB/s
  collective_s = ring-model wire bytes a rank / the link's rate: NVLink 4
                 inside one node (data x model <= 8 GPUs), the network
                 beyond it

FLOPs and collectives come from the trace (``analysis.cost``).  The memory
term uses JAX's analytic model: the trace's operand + result bytes
(``hlo_memory_s``) charge every eager op's full traffic, which a fused
step would not move, so they are reported as an upper bound beside it.

Analytic HBM model per rank per step (bytes):
  train:   3x param reads (fwd + bwd + remat-fwd) + param write
           + opt moments read+write + f32 grad accum read+write
           + 2x layer-input checkpoints (write + read)
           + ACT_ALPHA x per-layer activation traffic
  prefill: 1x param read + ACT_ALPHA activation traffic + KV write
  decode:  1x param read + full KV cache read + KV slice write

JAX's ``_mesh_extents`` fixes a model axis of 16 (its production mesh);
here every closed form takes the mesh's stated ``(data, model)`` extents.
MODEL_FLOPS / traced FLOPs measures useful compute (remat pushes it to
~0.75 on train cells).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.analysis.cost import WeightedCost
from repro_torch.models.config import ModelConfig

# NVIDIA H100 Tensor Core GPU data sheet (SXM5, dense, no sparsity)
PEAK_FLOPS = 989e12          # bf16 / GPU
TF32_FLOPS = 495e12          # TF32 tensor cores / GPU
FP32_FLOPS = 67e12           # fp32 CUDA cores / GPU
INT8_OPS = 1979e12           # int8 tensor cores / GPU
HBM_BW = 3.35e12             # HBM3 bytes/s / GPU
# NVLink 4: 18 links x 25 GB/s a direction = 450 GB/s a direction a GPU
# (900 GB/s both ways), all to all through NVSwitch inside one 8-GPU node
NVLINK_BW = 450e9
NODE_GPUS = 8
# between nodes: one 400 Gb/s NIC a GPU (ConnectX-7, DGX H100) = 50 GB/s
NET_BW = 50e9
HBM_CAPACITY = 80e9          # bytes of device memory a GPU (80 GB)
ACT_ALPHA = 14               # residual-stream touches per layer (fwd+bwd)

# the same data sheet's rates by H100 part: ``chip_smoke.py``'s bounds
PEAKS = {
    "sxm": {"fp32_flops": FP32_FLOPS, "tf32_flops": TF32_FLOPS,
            "bf16_flops": PEAK_FLOPS, "int8_ops": INT8_OPS,
            "bytes_per_s": HBM_BW},
    "pcie": {"fp32_flops": 51e12, "tf32_flops": 378e12, "bf16_flops": 756e12,
             "int8_ops": 1513e12, "bytes_per_s": 2.0e12},
    "nvl": {"fp32_flops": 60e12, "tf32_flops": 417.5e12,
            "bf16_flops": 835e12, "int8_ops": 1671e12,
            "bytes_per_s": 3.9e12},
}


def peaks_for(name: str) -> dict:
    """The rates of the H100 part a device name (``torch.cuda.
    get_device_name``) names: PCIe, NVL, else SXM."""
    low = name.lower()
    if "pcie" in low:
        return PEAKS["pcie"]
    if "nvl" in low:
        return PEAKS["nvl"]
    return PEAKS["sxm"]


def link_bw(data: int, model: int) -> float:
    """A rank's collective rate: NVLink inside one node, the network
    beyond it."""
    return NVLINK_BW if data * model <= NODE_GPUS else NET_BW


def model_params(cfg: ModelConfig, *, active: bool = False) -> int:
    """Closed-form N (total) or N_active (MoE top-k + shared only)."""
    if not active or cfg.num_experts == 0:
        return cfg.param_count_estimate()
    dense_like = dataclasses.replace(
        cfg, num_experts=cfg.experts_per_token)
    return dense_like.param_count_estimate()


def model_flops(cfg: ModelConfig, kind: str, seq_len: int, global_batch: int,
                *, decoder_frac: Optional[int] = None) -> float:
    """6*N*D (train) or 2*N*D (inference), N = active params, D = tokens."""
    n = model_params(cfg, active=True)
    if kind == "train":
        tokens = global_batch * seq_len
        if cfg.family == "encdec":
            tokens = global_batch * (seq_len + seq_len
                                     // (decoder_frac or cfg.decoder_train_frac))
        return 6.0 * n * tokens
    if kind == "prefill":
        return 2.0 * n * global_batch * seq_len
    return 2.0 * n * global_batch


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    if cfg.family == "encdec":
        per_tok = 2 * cfg.num_layers * cfg.kv_dim * 2
        cross = 2 * cfg.num_layers * 1500 * cfg.kv_dim * 2
        return batch * (seq_len * per_tok + cross)
    n_attn = cfg.num_blocks * cfg.attn_layers_per_block
    kv = batch * seq_len * 2 * n_attn * cfg.kv_dim * 2
    n_mamba = cfg.num_blocks * cfg.mamba_layers_per_block
    ssm = batch * n_mamba * (cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim
                             * 4 + (cfg.ssm_conv_width - 1)
                             * (cfg.ssm_d_inner + 2 * cfg.ssm_state) * 2)
    return kv + ssm


def analytic_memory_bytes(cfg: ModelConfig, kind: str, seq_len: int,
                          global_batch: int, mesh: tuple[int, int], *,
                          grad_accum: int = 1, fsdp: bool = False,
                          opt_state_bytes: int = 4) -> float:
    """HBM bytes a rank moves in one step on a ``(data, model)`` mesh (a
    pod axis folds into ``data``)."""
    data_ext, model_ext = mesh
    n_devices = data_ext * model_ext
    n_total = model_params(cfg)
    n_active = model_params(cfg, active=True)
    # dense/attention params are read on every data shard; expert params are
    # read only by their owner (EP), approximated via the active/total split
    expert_shards = min(data_ext, max(cfg.num_experts, 1))
    p_read_local = (n_active / model_ext
                    + max(n_total - n_active, 0) / (model_ext * expert_shards))
    p_state_local = n_total / (model_ext * (data_ext if fsdp else 1))
    tokens_local = global_batch * seq_len / data_ext
    d = cfg.d_model
    layers = cfg.num_layers + cfg.encoder_layers

    if kind == "train":
        act_stream = tokens_local * d * 2
        traffic = (
            3 * p_read_local * 2                      # fwd, bwd, remat reads
            + p_state_local * 2                       # param write
            + p_state_local * 2 * 2 * opt_state_bytes  # m, v read+write
            + p_state_local * 2 * 4                   # grad accum r+w (f32)
            + 2 * layers * act_stream                 # checkpoint w+r
            + ACT_ALPHA * layers * act_stream         # recompute traffic
        )
        return traffic
    if kind == "prefill":
        act_stream = tokens_local * d * 2
        return (p_read_local * 2 + ACT_ALPHA / 2 * layers * act_stream
                + kv_cache_bytes(cfg, global_batch, seq_len) / n_devices)
    # decode: read all local params + the local KV cache slice, write 1 token
    cache_local = kv_cache_bytes(cfg, global_batch, seq_len) / n_devices
    return p_read_local * 2 + cache_local


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float       # analytic
    hlo_bytes_per_device: float   # the trace's operand + result bytes
    wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    hlo_memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    useful_flops_ratio: float
    collectives: WeightedCost

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "hlo_bytes_per_device": self.hlo_bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "hlo_memory_s": self.hlo_memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "collective_ops": self.collectives.collective_ops,
            "collective_wire_bytes": self.collectives.wire_bytes,
        }


def analyze(cost: WeightedCost, cfg: ModelConfig, kind: str, seq_len: int,
            global_batch: int, mesh: tuple[int, int], *,
            grad_accum: int = 1, fsdp: bool = False,
            opt_state_bytes: int = 4) -> Roofline:
    """The roofline of one rank's traced ``cost`` (``cost.count``) on a
    ``(data, model)`` mesh."""
    data, model = mesh
    flops = cost.flops
    abytes = analytic_memory_bytes(
        cfg, kind, seq_len, global_batch, mesh, grad_accum=grad_accum,
        fsdp=fsdp, opt_state_bytes=opt_state_bytes)
    compute_s = flops / PEAK_FLOPS
    memory_s = abytes / HBM_BW
    hlo_memory_s = cost.hbm_bytes / HBM_BW
    coll_s = cost.total_wire_bytes / link_bw(data, model)
    dominant = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", coll_s)), key=lambda kv: kv[1])[0]
    mf = model_flops(cfg, kind, seq_len, global_batch)
    useful = mf / max(flops * data * model, 1.0)
    return Roofline(
        flops_per_device=flops, bytes_per_device=abytes,
        hlo_bytes_per_device=cost.hbm_bytes,
        wire_bytes_per_device=cost.total_wire_bytes,
        compute_s=compute_s, memory_s=memory_s, hlo_memory_s=hlo_memory_s,
        collective_s=coll_s, dominant=dominant, model_flops_total=mf,
        useful_flops_ratio=useful, collectives=cost)
