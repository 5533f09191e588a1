"""Plain references that judge the program's answers. They import
neither JAX nor either package of this repository."""
