from .prop_model import EnEquiEncoder, PropPredNet, PropPredNetEnc  # noqa: F401
