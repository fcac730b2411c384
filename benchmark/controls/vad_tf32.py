"""The control of the speech probabilities: the reference PyanNet
computed in TF32 (cuDNN's and cuBLAS's TF32 switches on) in the program's
place, one precision below the float32 that the program's PyanNet states.
The windows the program dispatched and its served tokens stay its own."""

from reference import pyannet_ref


def speech_probs(model, audio, device):
    return pyannet_ref.speech_probs(model, audio, device, tf32=True)[0]
