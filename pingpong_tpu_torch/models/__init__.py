from pingpong_tpu_torch.models.noisy import Dense, NoisyLinear, NoisyNoise
from pingpong_tpu_torch.models.policy import (
    epsilon_greedy,
    qnet_act_greedy,
    qnet_act_train,
)
from pingpong_tpu_torch.models.qnet import (
    QNet,
    QNetNoise,
    qnet_apply,
    qnet_fold_noise,
    qnet_init,
    qnet_sample_noise,
)

__all__ = [
    "Dense", "NoisyLinear", "NoisyNoise", "QNet", "QNetNoise",
    "epsilon_greedy", "qnet_act_greedy", "qnet_act_train", "qnet_apply",
    "qnet_fold_noise", "qnet_init",
    "qnet_sample_noise",
]
