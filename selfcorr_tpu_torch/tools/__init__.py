"""The port's command-line tools: shape priors (gen_priors), Wild6D video
lists (gen_lists) and the learning check on the synthetic duo videos
(validate_synthetic). Each runs as python -m selfcorr_tpu_torch.tools.<name>.
"""
