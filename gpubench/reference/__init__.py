"""The plain float32 references, one module a model family (imports nothing
of the program), and what every comparison with them shares."""


def no_tf32() -> None:
    """A float32 product on the card must not run in TF32."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
