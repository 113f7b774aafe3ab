"""`open_results` console entry (reference `open_results.py`)."""
from ptv_interpolation_tpu_torch.cli.tools import open_results as main

if __name__ == "__main__":
    main()
