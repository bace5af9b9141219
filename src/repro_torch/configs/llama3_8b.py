"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 [arXiv:2407.21783; unverified]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", kind="decoder",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, rope_theta=500_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3-smoke", kind="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=176, vocab=512,
    )
