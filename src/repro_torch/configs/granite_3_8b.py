"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155 [hf:ibm-granite; hf]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", kind="decoder",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab=49155,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", kind="decoder",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=192, vocab=512,
    )
