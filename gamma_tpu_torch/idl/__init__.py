from gamma_tpu_torch.idl import wire  # noqa: F401
