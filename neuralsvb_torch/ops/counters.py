"""The launch counters of the port's hand-written kernels, in one list: each
is a wrapper whose ``launches`` attribute counts its kernel launches (for
``amp_conv_backward_cuda`` and ``mrd_conv_backward_cuda``, their
convolution backwards). The trainer's summary reports each as
``<name>_launches``; a kernel module adds its counter here."""

from .amp_activation import amp_backward_cuda, amp_forward_cuda
from .amp_conv import amp_conv_backward_cuda
from .fused_resblock import KERNEL_COUNTERS
from .mrd_conv import mrd_conv_backward_cuda

COUNTERS = KERNEL_COUNTERS + (amp_forward_cuda, amp_backward_cuda, amp_conv_backward_cuda,
                              mrd_conv_backward_cuda)
