from .measure import (cosine_similarity, kl_divergence, mean_square_error,
                      snr_error, torch_cosine_similarity, torch_KL_divergence,
                      torch_mean_square_error, torch_snr_error)
from .observers import (OBSERVER_TABLE, BaseTensorObserver, KLObserver,
                        MinMaxObserver, MSEObserver, PercentileObserver,
                        build_observer, minmax_to_scale_offset)
from .qfunction import (fake_quant_np, linear_fake_quant, linear_quant_codes,
                        ppq_fake_quant, ppq_quant_toint)
from .rounding import round_scalar, round_tensor, round_to_power_of_2
