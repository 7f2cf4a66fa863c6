from eventful_transformer_tpu_torch.data.synthetic import SyntheticVideoClassification

__all__ = ["SyntheticVideoClassification"]
