from eventful_transformer_tpu_torch.parallel.mesh import make_mesh, spawn

__all__ = ["make_mesh", "spawn"]
