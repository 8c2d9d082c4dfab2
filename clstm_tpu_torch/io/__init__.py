"""Serialization and host-side I/O: .clstm model files and their message
tree, line normalization, PNG I/O (port of clstm_tpu/io).

``proto_of_net`` and ``net_of_proto`` give and take the message classes of
io/clstm_pb2.py, written by hand without the protobuf package; any object
with the same fields (a protobuf message of the JAX package) is read too.
"""

from clstm_tpu_torch.io.proto import (load_net, net_of_proto, proto_of_net,
                                      save_net)

__all__ = ["save_net", "load_net", "proto_of_net", "net_of_proto"]
