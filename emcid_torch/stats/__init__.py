from emcid_torch.stats.running import (
    Stat,
    Mean,
    NormMean,
    Variance,
    Covariance,
    SecondMoment,
    CombinedStat,
    tally,
    cache_load_enabled,
    load_cached_state,
    save_cached_state,
    box_numpy_null,
    unbox_numpy_null,
    null_numpy_value,
    FixedRandomSubsetSampler,
)
from emcid_torch.stats.extras import Quantile, TopK, Bincount, History, IoU
