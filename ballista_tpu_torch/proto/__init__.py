"""Generated protobuf wire contract (see ballista.proto).

Regenerate with:  protoc --python_out=. ballista.proto
"""

from . import ballista_pb2  # noqa: F401
