"""`plot_flux` console entry (reference `plot_flux.py`)."""
from ptv_interpolation_tpu_torch.cli.tools import plot_flux as main

if __name__ == "__main__":
    main()
