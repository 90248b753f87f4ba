from csl_gan_tpu_torch.privacy.rdp import compute_rdp, get_privacy_spent, DEFAULT_ALPHAS
from csl_gan_tpu_torch.privacy.accountant import (RdpAccountant, ZcdpAccountant,
                                                  accountant_from_state_dict,
                                                  make_accountant)
from csl_gan_tpu_torch.privacy.mean_sampler import MeanSampler
