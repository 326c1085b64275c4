"""FastSpeech2 with the multi-window mel discriminator; port of
``neuralsvb_tpu/tasks/fs2_adv.py`` (reference: tasks/tts/fs2_adv.py:11-128),
the ``egs/egs_bases/{tts,singing}/fs2_adv_torch.yaml`` recipes. The
adversarial steps are ``AdversarialTaskBase``'s; the recipe's ``mel_gan``
turns the discriminator on."""

from .fs2 import FastSpeech2Task


class FastSpeech2AdvTask(FastSpeech2Task):
    pass
