"""tinyllama-1.1b [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small [arXiv:2401.02385; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", kind="decoder",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab=32000,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", kind="decoder",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=512,
    )
