"""`compare_results` console entry (reference `compare_results.py`)."""
from ptv_interpolation_tpu_torch.cli.tools import compare_results as main

if __name__ == "__main__":
    main()
