from eventful_transformer_tpu_torch.models.vivit import FactorizedViViT  # noqa: F401
from eventful_transformer_tpu_torch.models.vitdet import ViTDet  # noqa: F401
