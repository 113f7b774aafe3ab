"""`view_divergence` console entry (reference `view_divergence.py`)."""
from ptv_interpolation_tpu_torch.cli.tools import view_divergence as main

if __name__ == "__main__":
    main()
