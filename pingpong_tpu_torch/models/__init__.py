from pingpong_tpu_torch.models.noisy import Dense, NoisyLinear, NoisyNoise
from pingpong_tpu_torch.models.policy import (
    epsilon_greedy,
    qnet_act_greedy,
    qnet_act_train,
    rnn_act_greedy,
    rnn_act_train,
)
from pingpong_tpu_torch.models.qnet import (
    QNet,
    QNetNoise,
    bot_qnet_params,
    qnet_apply,
    qnet_fold_noise,
    qnet_init,
    qnet_sample_noise,
)
from pingpong_tpu_torch.models.qnet_rnn import (
    Hidden,
    QNetRNN,
    QNetRNNNoise,
    init_hidden,
    qnet_rnn_apply,
    qnet_rnn_init,
    qnet_rnn_sample_noise,
    qnet_rnn_step,
)

__all__ = [
    "Dense", "NoisyLinear", "NoisyNoise", "QNet", "QNetNoise",
    "bot_qnet_params",
    "epsilon_greedy", "qnet_act_greedy", "qnet_act_train", "qnet_apply",
    "qnet_fold_noise", "qnet_init",
    "qnet_sample_noise", "Hidden", "QNetRNN", "QNetRNNNoise", "init_hidden",
    "qnet_rnn_apply", "qnet_rnn_init", "qnet_rnn_sample_noise",
    "qnet_rnn_step", "rnn_act_greedy", "rnn_act_train",
]
