from emcid_torch.stats.running import (
    CombinedStat,
    Mean,
    SecondMoment,
    Stat,
    box_numpy_null,
    load_cached_state,
    null_numpy_value,
    save_cached_state,
    tally,
    unbox_numpy_null,
)
