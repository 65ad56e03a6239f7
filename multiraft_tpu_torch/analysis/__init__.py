"""The dynamic lock-order recorder the runtime sanitizer installs
(``MRT_SANITIZE=1``)."""
