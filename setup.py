from setuptools import find_packages, setup

setup(
    name="pix2latent_tpu",
    version="0.1.0",
    description=("TPU-native JAX framework for inverting images into "
                 "generative models (BasinCMA / CMA-ES / Adam hybrid "
                 "optimization, transform search, BigGAN + StyleGAN2)"),
    packages=find_packages(exclude=("tests", "examples")),
    package_data={"pix2latent_tpu": ["utils/data/*.json.gz"],
                  "pix2latent_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                           "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
        "Pillow",
        "imageio",
    ],
    extras_require={
        "convert": ["torch"],          # pretrained checkpoint conversion
        "video": ["opencv-python"],    # webm writer, seamless clone fallback
        "wordnet": ["nltk"],           # hyponym class queries
        "test": ["pytest"],
    },
)
