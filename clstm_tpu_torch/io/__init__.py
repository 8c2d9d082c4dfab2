"""Serialization and host-side I/O: .clstm model files, line
normalization, PNG I/O (port of clstm_tpu/io).

Exports the JAX package's names but ``proto_of_net`` and ``net_of_proto``:
they take and give protobuf messages, and the port reads and writes the
.clstm format by hand, without the protobuf package (io/proto.py).
"""

from clstm_tpu_torch.io.proto import save_net, load_net

__all__ = ["save_net", "load_net"]
