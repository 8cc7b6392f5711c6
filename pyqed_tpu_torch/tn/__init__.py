from .ttals import tt_svd, tt_als, tt_to_dense, tt_eval, tt_rank
