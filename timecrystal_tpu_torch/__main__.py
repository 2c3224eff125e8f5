"""``python -m timecrystal_tpu_torch``: the figure-generation CLI (main.py)."""

from .main import main

if __name__ == "__main__":
    main()
