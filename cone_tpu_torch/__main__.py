"""`python -m cone_tpu_torch <infer|eval|ensemble|serve> ...`."""

from cone_tpu_torch.cli import main

if __name__ == "__main__":
    main()
