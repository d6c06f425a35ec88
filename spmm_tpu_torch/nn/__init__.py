"""Graph layers built on the port's sparse ops."""

from spmm_tpu_torch.nn.graph_attention import GraphTransformer, TransformerConv

__all__ = ["GraphTransformer", "TransformerConv"]
