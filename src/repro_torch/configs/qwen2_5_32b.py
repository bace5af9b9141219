"""qwen2.5-32b [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064, QKV bias [hf:Qwen; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b", kind="decoder",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=27648, vocab=152064, qkv_bias=True, rope_theta=1_000_000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", kind="decoder",
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_ff=192, vocab=512,
        qkv_bias=True,
    )
