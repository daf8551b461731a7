"""Plain references that decide `correct`. They import neither JAX nor the
JAX package nor anything of the port, and take nothing the port made."""
