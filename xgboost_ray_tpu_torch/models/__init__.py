from xgboost_ray_tpu_torch.models.booster import Booster, RayXGBoostBooster

__all__ = ["Booster", "RayXGBoostBooster"]
