"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32 = MHA)
d_ff=8192 vocab=32064; phi3-mini + CLIP [hf:microsoft; hf].

The CLIP tower is a stub per assignment: input_specs() provides 576
precomputed patch embeddings; the model learns only a projection.
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", kind="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32064, frontend="vision", frontend_len=576,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3v-smoke", kind="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        frontend="vision", frontend_len=16,
    )
