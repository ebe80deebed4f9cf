from .exec import mpp_filter_agg, mpp_shuffle_join_agg, mpp_global_sum

__all__ = ["mpp_filter_agg", "mpp_shuffle_join_agg", "mpp_global_sum"]
