"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", kind="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280,
        d_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", kind="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, d_ff=0, vocab=512,
        d_state=16, ssm_head_dim=16, ssm_chunk=16,
    )
