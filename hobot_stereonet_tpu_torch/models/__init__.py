from .fast_stereonet import CorrelationAggregation2D, FastStereoNet
from .stereonet import FeatureTower
