"""One PyTorch thread for a test module, and for the processes it starts.

The suite runs in several worker processes on shared cores: a module whose
small tensors ran on every core would crowd the other workers, the JAX
package's timing tests among them. A module calls pin_one_thread() once,
where it is imported; a subprocess it starts gets ONE_THREAD_ENV in its
environment.
"""

import torch

ONE_THREAD_ENV = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def pin_one_thread() -> None:
    torch.set_num_threads(1)
