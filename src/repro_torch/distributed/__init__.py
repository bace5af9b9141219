"""Distribution substrate of the port (the reference's ``distributed/``):
logical-axis sharding rules, the loss, int8 gradient compression, the
GPipe pipeline and the tensor-parallel split over ``"model"``
(``tensor_parallel``: its autograd collectives and the slicing rule of
every family). Its collectives go through ``engine/mesh.py``'s counted
helpers."""

from repro_torch.distributed.compression import compressed_psum_tree, quantize_ef
from repro_torch.distributed.pipeline import bubble_fraction, pipeline_apply
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    ShardingRules,
    constrain,
    logical_to_spec,
    param_specs,
)
from repro_torch.distributed.xent import cross_entropy

__all__ = [
    "ShardingRules",
    "DEFAULT_RULES",
    "logical_to_spec",
    "param_specs",
    "constrain",
    "cross_entropy",
    "pipeline_apply",
    "bubble_fraction",
    "compressed_psum_tree",
    "quantize_ef",
]
