from eventful_transformer_tpu_torch.models.vivit import FactorizedViViT  # noqa: F401
