"""Request/response/document data model.

The reference serializes every call through flatbuffers (idl/fbs/*.fbs,
c_api/api_data/*).  This build keeps the same logical schema as plain
dataclasses with JSON round-trips; a zero-copy wire format can bolt on
at the boundary without touching the engine.
"""
