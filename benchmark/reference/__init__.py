"""Plain PyTorch references of what the program computes. Nothing in this
package imports the program, JAX or the JAX package."""
