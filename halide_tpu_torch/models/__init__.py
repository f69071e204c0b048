"""NN models on the Func DSL: layer builders (nn) and ResNet-50
(resnet50), the counterparts of the JAX package's models."""
